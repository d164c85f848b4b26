"""Command-line interface of the port: training, the serve and eval chain of
the tfcgan, stn and nemar recipes, and the diffusion family's sampler:

    python -m tfcgan_tpu_torch.cli train --experiment fft_glo --data-root DATA \
        --batch-size 32 --n-epochs 201 --out-dir runs/fft_glo
    python -m tfcgan_tpu_torch.cli train --experiment fft_glo --data-root DATA \
        --resume runs/fft_glo/step_00000403 --out-dir runs/fft_glo
    python -m tfcgan_tpu_torch.cli test --experiment fft_glo --data-root DATA \
        --checkpoint runs/fft_glo/step_00000403 --out-dir results/ --spectra
    python -m tfcgan_tpu_torch.cli test --config stn_newmodel3 --data-root DATA \
        --params g_params.npz --out-dir results/
    python -m tfcgan_tpu_torch.cli test --config nemar --data-root DATA \
        --params g_params.npz --out-dir results/
    python -m tfcgan_tpu_torch.cli gen --config tfc_diff --data-root DATA \
        --checkpoint runs/tfc_diff/step_00000201 --out-dir samples/ --seed 0
    python -m tfcgan_tpu_torch.cli prep-crop --stack-dir results/ --out-root crops/
    python -m tfcgan_tpu_torch.cli eval --fake-dir crops/fake_B --real-dir crops/real_B

``train`` follows the JAX CLI's ``cmd_train``: the dataset under
``DATA/train`` (and ``--extra-root`` for the balanced two-dataset entries),
step 0 on the first batch, then ``--n-epochs`` epochs of ``len // batch``
steps; input staged in device memory (``--staging pool``, the default under
2 GiB) or streamed by ``--num-workers`` threads; a JSONL log under
``OUT/logs``, sample stacks of the first 4 test pairs under ``OUT/samples``
every ``--sample-interval`` steps, and a checkpoint ``OUT/step_%08d`` every
``--checkpoint-interval`` epochs and at the end. ``--resume`` restores a
checkpoint and restarts the data order. ``test`` and ``gen`` serve the
weights of a checkpoint (``--checkpoint``), of a JAX checkpoint turned into
``g_params.npz`` by ``tools/export_g_params.py`` (``--params``; for stn it
holds G1, G2 and the STN, for nemar T and R) or random ones (``--init-seed
N``). The stn stacks are real_A | real_B | warped_B | fake_A1 | fake_A2 |
fake_B (``prep-crop --roles real_A,real_B,warped_B,fake_A1,fake_A2,fake_B``),
the nemar stacks real_A | real_B | registered_A | fake_B | fake_TR_B |
fake_RT_B (``--roles real_A,real_B,reg_A,fake_B,fake_TR_B,fake_RT_B``).
``gen`` runs the on-device ancestral sampler of a diffusion experiment over
the test set, batch 4 by default, and writes real_A | sample stacks.
``--device`` defaults to ``cuda``, and the commands refuse to run when CUDA
is absent unless ``--device cpu`` is given.
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
    # replace() keeps the registry's fields the CLI does not set
    data = dataclasses.replace(
        cfg.data,
        root=args.data_root or cfg.data.root,
        batch_size=args.batch_size or cfg.data.batch_size,
        image_size=args.image_size or cfg.data.image_size,
        direction=args.direction or cfg.data.direction,
        num_workers=cfg.data.num_workers if args.num_workers is None else args.num_workers,
        staging=args.staging or cfg.data.staging,
    )
    train = dataclasses.replace(
        cfg.train,
        n_epochs=args.n_epochs or cfg.train.n_epochs,
        sample_interval=args.sample_interval or cfg.train.sample_interval,
        checkpoint_interval=args.checkpoint_interval or cfg.train.checkpoint_interval,
        compute_dtype=args.dtype or cfg.train.compute_dtype,
        checkpoint_dir=args.out_dir or cfg.train.checkpoint_dir,
        log_dir=os.path.join(args.out_dir or ".", "logs"),
    )
    return cfg.replace(data=data, train=train)


def _serve_constructor(cfg):
    """The function that makes the recipe's serve-side modules: they have
    ``recipe.G``'s layout."""
    from tfcgan_tpu_torch.recipes import diffusion, nemar, stn, tfcgan

    constructors = {"tfcgan": tfcgan.build_generator, "stn": stn.build_generators,
                    "nemar": nemar.build_generators, "diffusion": diffusion.build_generators}
    if cfg.recipe not in constructors:
        raise SystemExit(f"recipe {cfg.recipe!r} has no serve path in the port yet")
    return constructors[cfg.recipe]


def _make_sample_hook(cfg, args, device):
    """``sample_hook(state, step)``: generate on the first (up to) 4 test
    pairs and write A | output | B columns to OUT/samples/%07d.png and the
    gallery; None when the dataset has no test split."""
    from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
    from tfcgan_tpu_torch.evaluation.gallery import write_gallery
    from tfcgan_tpu_torch.evaluation.suite import save_image_grid
    from tfcgan_tpu_torch.infer import Inferencer

    try:
        test_ds = PairedImageDataset(cfg.data.root, "test", cfg.data.image_size,
                                     cfg.data.direction)
    except FileNotFoundError:
        return None  # no test split: no sampling
    batch = next(batch_iterator(test_ds, min(4, len(test_ds)), shuffle=False, epochs=1))
    sample_dir = os.path.join(args.out_dir or ".", "samples")
    serve = []  # the eval-mode copy of G, built at the first call

    def sample_hook(state, step):
        if not serve:
            serve.append(_serve_constructor(cfg)(cfg, device, torch.Generator().manual_seed(0)))
        serve[0].load_state_dict(state.G.state_dict())
        out = Inferencer(cfg, serve[0])(batch)
        out = (out["fake_B"] if isinstance(out, dict) else out).float().cpu().numpy()
        if out.shape[-1] == 1:  # a gray diffusion sample
            out = out.repeat(3, -1)
        stack = [np.concatenate([batch["A"][i], out[i], batch["B"][i]], axis=0)
                 for i in range(out.shape[0])]
        save_image_grid(stack, os.path.join(sample_dir, f"{step:07d}.png"), axis=1)
        write_gallery(sample_dir, title=cfg.name)

    return sample_hook


def cmd_train(args):
    from tfcgan_tpu_torch.data.mixture import BalancedMixture
    from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
    from tfcgan_tpu_torch.data.prefetch import device_prefetch
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.checkpoint import AsyncCheckpointManager, restore_checkpoint
    from tfcgan_tpu_torch.train.log import JsonlLogger
    from tfcgan_tpu_torch.train.profiling import count_params
    from tfcgan_tpu_torch.train.state import ReduceLROnPlateau, set_learning_rate
    from tfcgan_tpu_torch.train.trainer import Trainer

    if args.annots:
        raise SystemExit("--annots feeds the conditional (debiased) recipes, which the port "
                         "does not build yet")
    device = _device(args.device)
    cfg = _cfg_from_args(args)
    recipe = build_recipe(cfg, device)
    roots = [cfg.data.root, *(args.extra_root or cfg.data.extra_roots or [])]
    roots = [r for r in roots if r]
    if cfg.extra.get("needs_extra_root") and len(roots) < 2:
        raise SystemExit(
            f"experiment {cfg.name!r} trains a balanced two-dataset mixture "
            f"(favtgan_..._TripTemp_ED.py:349-374): pass the second dataset "
            f"via --extra-root <path>")
    if getattr(recipe, "variant", None) in ("label", "hybrid"):
        raise SystemExit(f"experiment {cfg.name!r} trains on class labels, which the port's "
                         "loader does not read yet")
    datasets = [PairedImageDataset(r, "train", cfg.data.image_size, cfg.data.direction)
                for r in roots]
    # kept local, as in the JAX CLI: the closed-form schedules see
    # cfg.train.steps_per_epoch (None -> 1), not the dataset's
    steps_per_epoch = min(len(d) for d in datasets) // cfg.data.batch_size
    logger = JsonlLogger(os.path.join(cfg.train.log_dir, f"{cfg.name}.jsonl"))
    trainer = Trainer(cfg, recipe, logger=logger)
    staged = False  # True when `it` yields batches on the device (or pool indices)
    pool = None
    if len(datasets) > 1:
        # balanced multi-dataset training (favtgan ED/EA)
        it = BalancedMixture(
            [(lambda d=d: batch_iterator(d, cfg.data.batch_size // len(datasets),
                                         seed=cfg.train.seed, epochs=1))
             for d in datasets],
            cfg.data.batch_size, seed=cfg.train.seed)
    else:
        staging = cfg.data.staging
        est = len(datasets[0]) * cfg.data.image_size ** 2 * 6  # A+B uint8 bytes
        if staging == "auto":
            staging = "pool" if est < (2 << 30) else "stream"
        if staging == "pool":
            from tfcgan_tpu_torch.data.pool import DevicePool

            pool = DevicePool(datasets[0], device, log_every=500)
            it = pool.index_batches(cfg.data.batch_size, seed=cfg.train.seed)
            staged = True
        elif cfg.data.num_workers > 0:
            from tfcgan_tpu_torch.data.prefetch import PrefetchLoader

            if est < (2 << 30):  # decode once, serve later epochs from RAM
                datasets[0].enable_cache()
            loader = PrefetchLoader(datasets[0], cfg.data.batch_size,
                                    num_workers=cfg.data.num_workers, seed=cfg.train.seed,
                                    raw=True)
            it = device_prefetch(iter(loader), device, via_uint8=True)
            staged = True
        else:
            it = batch_iterator(datasets[0], cfg.data.batch_size, seed=cfg.train.seed)
    first = next(it)
    state = trainer.init_state(cfg.train.seed)
    print(f"G params: {count_params(state.G):,} | D params: {count_params(state.D):,} | "
          f"device: {device}")
    if args.resume:
        # the data order restarts: `first` was drawn and is not stepped
        state = restore_checkpoint(args.resume, state)
        print(f"resumed from {args.resume} at step {state.step}")
    else:
        state = trainer.fit(state, [first], pool=pool)  # step 0

    sample_hook = _make_sample_hook(cfg, args, device)
    ckpt_mgr = AsyncCheckpointManager(cfg.train.checkpoint_dir)
    # metric-driven lr (NeMAR 'plateau'): stepped once an epoch on loss_G; a
    # resume starts a fresh controller, as the JAX CLI does
    plateau = ReduceLROnPlateau(cfg.optim.lr) if cfg.optim.schedule == "plateau" else None
    if not staged:
        it = device_prefetch(it, device)  # copies overlap the running step
    for epoch in range(cfg.train.n_epochs):
        state = trainer.fit(state, it, num_steps=steps_per_epoch, check_finite=True,
                            sample_hook=sample_hook, pool=pool)
        if plateau is not None and trainer.last_metrics is not None:
            set_learning_rate(state, plateau.step(float(trainer.last_metrics["loss_G"])))
        if cfg.train.checkpoint_interval > 0 and epoch % cfg.train.checkpoint_interval == 0:
            path = ckpt_mgr.save(state)  # the write overlaps the next epoch
            print(f"\n[epoch {epoch}] checkpoint -> {path}")
    ckpt_mgr.save(state)
    ckpt_mgr.close()
    logger.close()


def _serve_weights(args, cfg, device) -> torch.nn.Module:
    """The served module with the weights of --checkpoint, --params or
    --init-seed (exactly one)."""
    from tfcgan_tpu_torch import bridge
    from tfcgan_tpu_torch.train.checkpoint import load_generator_state

    if sum(w is not None for w in (args.checkpoint, args.params, args.init_seed)) != 1:
        raise SystemExit("pass exactly one of --checkpoint DIR, --params g_params.npz and "
                         "--init-seed N")
    seed = 0 if args.init_seed is None else args.init_seed
    module = _serve_constructor(cfg)(cfg, device, torch.Generator().manual_seed(seed))
    if args.checkpoint is not None:
        module.load_state_dict(load_generator_state(args.checkpoint))
    elif args.params is not None:
        npz = {"tfcgan": bridge.load_generator_npz, "stn": bridge.load_stn_generators_npz,
               "nemar": bridge.load_nemar_generators_npz,
               "diffusion": bridge.load_diffusion_generators_npz}[cfg.recipe]
        module.load_state_dict(npz(args.params))
    return module


def cmd_test(args):
    from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
    from tfcgan_tpu_torch.infer import Inferencer

    device = _device(args.device)
    cfg = _cfg_from_args(args)
    if cfg.recipe == "diffusion":
        raise SystemExit("test serves the GAN recipes; use gen for a diffusion experiment")
    g = _serve_weights(args, cfg, device)
    ds = PairedImageDataset(cfg.data.root, "test", cfg.data.image_size, cfg.data.direction)
    # drop_last=False: every test image is served
    batches = batch_iterator(ds, args.batch_size or 8, shuffle=False, epochs=1, drop_last=False)
    n = Inferencer(cfg, g).run_test_set(batches, args.out_dir, save_spectra=args.spectra)
    print(f"wrote {n} stacks to {args.out_dir}")


def cmd_gen(args):
    """Diffusion sampling: the whole chain on the device for every test image."""
    from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
    from tfcgan_tpu_torch.infer import Inferencer

    device = _device(args.device)
    cfg = _cfg_from_args(args)
    if cfg.recipe != "diffusion":
        raise SystemExit("gen is for diffusion experiments")
    nets = _serve_weights(args, cfg, device)
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

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--data-root", default=None)
    common.add_argument("--batch-size", type=int, default=None)
    common.add_argument("--image-size", type=int, default=None)
    common.add_argument("--n-epochs", type=int, default=None)
    common.add_argument("--checkpoint-interval", type=int, default=None)
    common.add_argument("--sample-interval", type=int, default=None)
    common.add_argument("--direction", default=None, choices=[None, "AtoB", "BtoA"])
    common.add_argument("--num-workers", type=int, default=None,
                        help="decode threads for the streaming input path")
    common.add_argument("--staging", default=None, choices=[None, "auto", "pool", "stream"],
                        help="input staging: the uint8 set in device memory (pool) or "
                             "threaded uint8 streaming (stream); auto: pool under 2 GiB")
    common.add_argument("--dtype", default=None, choices=[None, "bfloat16", "float32"])
    common.add_argument("--out-dir", default="runs")
    common.add_argument("--annots", default=None,
                        help="annotations CSV of the conditional recipes (not built by the "
                             "port yet: refused)")
    common.add_argument("--device", default="cuda")

    train_help = ("train an experiment (weight and gradient histograms, the JAX CLI's "
                  "--hist-every, are not ported yet)")
    sp = sub.add_parser("train", parents=[common], help=train_help, description=train_help)
    sp.add_argument("--experiment", "--config", dest="experiment", default="fft_glo")
    sp.add_argument("--resume", default=None, help="checkpoint directory to resume from")
    sp.add_argument("--extra-root", action="append", default=None,
                    help="additional dataset root(s) for balanced mixtures")
    sp.set_defaults(fn=cmd_train)

    for name, fn, default in (("test", cmd_test, "fft_glo"), ("gen", cmd_gen, "tfc_diff")):
        sp = sub.add_parser(name, parents=[common])
        sp.add_argument("--experiment", "--config", dest="experiment", default=default)
        sp.add_argument("--checkpoint", default=None,
                        help="a checkpoint directory written by train (step_%%08d)")
        sp.add_argument("--params", default=None,
                        help="g_params.npz from tools/export_g_params.py")
        sp.add_argument("--init-seed", type=int, default=None,
                        help="serve random weights drawn from this seed")
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
