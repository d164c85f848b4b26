"""Command-line interface of the port (the serve and eval chain of the tfcgan,
stn and nemar recipes, and the diffusion family's sampler):

    python -m tfcgan_tpu_torch.cli test --experiment fft_glo --data-root DATA \
        --params g_params.npz --out-dir results/ --spectra
    python -m tfcgan_tpu_torch.cli test --config stn_newmodel3 --data-root DATA \
        --params g_params.npz --out-dir results/
    python -m tfcgan_tpu_torch.cli test --config nemar --data-root DATA \
        --params g_params.npz --out-dir results/
    python -m tfcgan_tpu_torch.cli gen --config tfc_diff --data-root DATA \
        --params g_params.npz --out-dir samples/ --seed 0
    python -m tfcgan_tpu_torch.cli prep-crop --stack-dir results/ --out-root crops/
    python -m tfcgan_tpu_torch.cli eval --fake-dir crops/fake_B --real-dir crops/real_B

``g_params.npz`` comes from a JAX checkpoint through ``tools/export_g_params.py``
(for stn it holds G1, G2 and the STN, for nemar T and R); ``--init-seed N``
serves random weights instead. The stn stacks are real_A | real_B | warped_B |
fake_A1 | fake_A2 | fake_B (``prep-crop --roles
real_A,real_B,warped_B,fake_A1,fake_A2,fake_B``), the nemar stacks real_A |
real_B | registered_A | fake_B | fake_TR_B | fake_RT_B (``--roles
real_A,real_B,reg_A,fake_B,fake_TR_B,fake_RT_B``). ``gen`` runs the on-device
ancestral sampler of a diffusion experiment (for it ``g_params.npz`` holds the
denoiser, the class embedding and, for the hybrid variant, G) over the test
set, batch 4 by default, and writes real_A | sample stacks. ``--device``
defaults to ``cuda``, and the commands refuse to run when CUDA is absent
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run on the host")
    return device


def _cfg_from_args(args):
    from tfcgan_tpu_torch.config import get_experiment

    cfg = get_experiment(args.experiment)
    data = dataclasses.replace(
        cfg.data,
        root=args.data_root or cfg.data.root,
        image_size=args.image_size or cfg.data.image_size,
        direction=args.direction or cfg.data.direction,
    )
    train = dataclasses.replace(cfg.train, compute_dtype=args.dtype or cfg.train.compute_dtype)
    return cfg.replace(data=data, train=train)


def cmd_test(args):
    from tfcgan_tpu_torch import bridge
    from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
    from tfcgan_tpu_torch.infer import Inferencer
    from tfcgan_tpu_torch.recipes import nemar, stn, tfcgan

    if (args.params is None) == (args.init_seed is None):
        raise SystemExit("pass exactly one of --params g_params.npz and --init-seed N")
    device = _device(args.device)
    cfg = _cfg_from_args(args)
    seed = 0 if args.init_seed is None else args.init_seed
    serving = {"tfcgan": (tfcgan.build_generator, bridge.load_generator_npz),
               "stn": (stn.build_generators, bridge.load_stn_generators_npz),
               "nemar": (nemar.build_generators, bridge.load_nemar_generators_npz)}
    if cfg.recipe not in serving:
        raise SystemExit(f"recipe {cfg.recipe!r} has no serve path in the port yet")
    build, load = serving[cfg.recipe]
    g = build(cfg, device, torch.Generator().manual_seed(seed))
    if args.params is not None:
        g.load_state_dict(load(args.params))
    ds = PairedImageDataset(cfg.data.root, "test", cfg.data.image_size, cfg.data.direction)
    # drop_last=False: every test image is served
    batches = batch_iterator(ds, args.batch_size or 8, shuffle=False, epochs=1, drop_last=False)
    n = Inferencer(cfg, g).run_test_set(batches, args.out_dir, save_spectra=args.spectra)
    print(f"wrote {n} stacks to {args.out_dir}")


def cmd_gen(args):
    """Diffusion sampling: the whole chain on the device for every test image."""
    from tfcgan_tpu_torch import bridge
    from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
    from tfcgan_tpu_torch.infer import Inferencer
    from tfcgan_tpu_torch.recipes import diffusion

    if (args.params is None) == (args.init_seed is None):
        raise SystemExit("pass exactly one of --params g_params.npz and --init-seed N")
    device = _device(args.device)
    cfg = _cfg_from_args(args)
    if cfg.recipe != "diffusion":
        raise SystemExit("gen is for diffusion experiments")
    seed = 0 if args.init_seed is None else args.init_seed
    nets = diffusion.build_generators(cfg, device, torch.Generator().manual_seed(seed))
    if args.params is not None:
        nets.load_state_dict(bridge.load_diffusion_generators_npz(args.params))
    ds = PairedImageDataset(cfg.data.root, "test", cfg.data.image_size, cfg.data.direction)
    batches = batch_iterator(ds, args.batch_size or 4, shuffle=False, epochs=1, drop_last=False)
    n = Inferencer(cfg, nets).run_test_set(batches, args.out_dir, seed=args.seed)
    print(f"sampled {n} images -> {args.out_dir}")


def cmd_prep_crop(args):
    from tfcgan_tpu_torch.evaluation.suite import crop_stack

    roles = args.roles.split(",")
    files = sorted(f for f in os.listdir(args.stack_dir) if f.endswith(".png"))
    out_dirs = [os.path.join(args.out_root, r) for r in roles]
    for f in files:
        crop_stack(os.path.join(args.stack_dir, f), out_dirs, num=len(roles))
    print(f"cropped {len(files)} stacks -> {args.out_root}")


def cmd_eval(args):
    from tfcgan_tpu_torch.evaluation.suite import evaluate_dirs

    table = evaluate_dirs(args.fake_dir, args.real_dir, args.out_csv, _device(args.device))
    for key, values in table.items():
        if key != "file":
            print(f"{key:<12} {np.mean(values):.6f}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="tfcgan_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    for name, fn, default in (("test", cmd_test, "fft_glo"), ("gen", cmd_gen, "tfc_diff")):
        sp = sub.add_parser(name)
        sp.add_argument("--experiment", "--config", dest="experiment", default=default)
        sp.add_argument("--data-root", default=None)
        sp.add_argument("--batch-size", type=int, default=None)
        sp.add_argument("--image-size", type=int, default=None)
        sp.add_argument("--direction", default=None, choices=[None, "AtoB", "BtoA"])
        sp.add_argument("--dtype", default=None, choices=[None, "bfloat16", "float32"])
        sp.add_argument("--out-dir", default="runs")
        sp.add_argument("--params", default=None,
                        help="g_params.npz from tools/export_g_params.py")
        sp.add_argument("--init-seed", type=int, default=None,
                        help="serve random weights drawn from this seed")
        sp.add_argument("--device", default="cuda")
        if name == "test":
            sp.add_argument("--spectra", action="store_true")
        else:
            sp.add_argument("--seed", type=int, default=0, help="the sampler's seed")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("prep-crop")
    sp.add_argument("--stack-dir", required=True)
    sp.add_argument("--out-root", required=True)
    sp.add_argument("--roles", default="real_A,fake_B,real_B")
    sp.set_defaults(fn=cmd_prep_crop)

    sp = sub.add_parser("eval")
    sp.add_argument("--fake-dir", required=True)
    sp.add_argument("--real-dir", required=True)
    sp.add_argument("--out-csv", default=None)
    sp.add_argument("--device", default="cuda")
    sp.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
