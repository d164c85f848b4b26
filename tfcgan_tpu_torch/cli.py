"""Command-line interface of the port: training, the serve and eval chain of
the GAN recipes (tfcgan, stn, nemar, cyclegan, thermalgan), and the diffusion
family's sampler:

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
    python -m tfcgan_tpu_torch.cli eval --fake-dir crops/fake_B --real-dir crops/real_B \
        --iqa niqe
    python -m tfcgan_tpu_torch.cli eval-reg --real-a-dir crops/real_A \
        --real-b-dir crops/real_B --reg-b-dir crops/warped_B --plots-dir plots/
    python -m tfcgan_tpu_torch.cli prep-combine --dir-a A/ --dir-b B/ --dir-ab AB/
    python -m tfcgan_tpu_torch.cli prep-morphs --in-dir crops/real_B --out-dir morphs/
    python -m tfcgan_tpu_torch.cli gallery --dir results/
    python -m tfcgan_tpu_torch.cli mesh --src-dir crops/real_A --out-dir mesh/

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
fake_RT_B (``--roles real_A,real_B,reg_A,fake_B,fake_TR_B,fake_RT_B``), the
cyclegan stacks real_A | fake_B | real_B | fake_A (``--roles
real_A,fake_B,real_B,fake_A``); thermalgan writes the tfcgan stacks, its
fake_B G2(G1(A, T_B)). The cyclegan ``g_params.npz`` holds G_AB and G_BA, the
thermalgan one G1, E and G2. Both families train on the paired A|B files, as
in the JAX CLI.
``gen`` runs the on-device ancestral sampler of a diffusion experiment over
the test set, batch 4 by default, and writes real_A | sample stacks.

The debiased (conditional) experiments, ``fft_patch_debiased_v1`` ... ``_v6``
and ``fft_patch_debiased``, train on the labels of ``--annots CSV``: a header
row, then one row an image, columns file, gender, ethnicity, age (read by
position; the file column's basename keys the image). Without ``--annots``
they are refused; the other experiments ignore it, as the JAX CLI does. Their
``train`` writes no sample grids and their ``test`` is refused: the test split
carries no labels (the JAX CLI reads none there either, and its Inferencer
then conditions every image on the labels (0, 0, 0)); serve them through
``infer.Inferencer`` with a batch's ``LAB3``.
``train --hist-every N`` logs the weight and gradient histograms of every
N-th step of each epoch's loop to ``OUT/hists.jsonl`` and renders
``OUT/hists.html`` at the end. ``eval --iqa niqe[,maniqa,dbcnn]`` adds
``<metric>_fake`` and ``<metric>_real`` columns (maniqa and dbcnn need
weights the repository does not have, and raise). ``eval-reg`` writes SSIM,
NCC and mutual information before and after registration (``--plots-dir``:
the 5-panel figures, with matplotlib); ``prep-combine`` pairs an A and a B
directory into A|B files; ``prep-morphs`` writes 1 - the morphological
gradient of each PNG; ``gallery`` an index.html over a directory; ``mesh``
face-landmark overlays, which need the optional mediapipe.
``--device`` defaults to ``cuda``, and the commands that compute on tensors
refuse to run when CUDA is absent unless ``--device cpu`` is given (the JAX
CLI's ``--cpu``); ``prep-combine``, ``prep-crop``, ``gallery`` and ``mesh``
take the flag as the JAX ones take ``--cpu``, and compute on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from tfcgan_tpu_torch.models.layers import without_draws


def _device(name: str) -> torch.device:
    """``--device``; under ``torchrun`` "cuda" is this process's card,
    ``cuda:$LOCAL_RANK``."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run on the host")
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def _data_mesh(device: torch.device, mesh_cfg=None):
    """Under ``torchrun`` (``WORLD_SIZE`` set): the process group (NCCL for a
    card, gloo for the host) and the mesh over it, even for a world of one:
    the data mesh, or the (data[, spatial][, tensor]) mesh that ``mesh_cfg``
    (the experiment's ``cfg.mesh``, with ``--spatial`` and ``--tensor``) asks for; None
    otherwise."""
    if "WORLD_SIZE" not in os.environ:
        return None
    from tfcgan_tpu_torch.parallel import initialize, make_mesh

    initialize(backend="nccl" if device.type == "cuda" else "gloo")
    if mesh_cfg is None:
        return make_mesh(device=device)
    return make_mesh(mesh_cfg.num_devices, spatial=mesh_cfg.spatial, tensor=mesh_cfg.tensor,
                     device=device)


def _leave_mesh(mesh) -> None:
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


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
    mesh = dataclasses.replace(cfg.mesh,
                               spatial=getattr(args, "spatial", None) or cfg.mesh.spatial,
                               tensor=getattr(args, "tensor", None) or cfg.mesh.tensor)
    return cfg.replace(data=data, train=train, mesh=mesh)


def _serve_constructor(cfg):
    """The function that makes the recipe's serve-side modules: they have
    ``recipe.G``'s layout."""
    from tfcgan_tpu_torch.recipes import cyclegan, diffusion, nemar, stn, tfcgan, thermalgan

    constructors = {"tfcgan": tfcgan.build_generator, "stn": stn.build_generators,
                    "nemar": nemar.build_generators, "diffusion": diffusion.build_generators,
                    "cyclegan": cyclegan.build_generators,
                    "thermalgan": thermalgan.build_generators}
    return constructors[cfg.recipe]


def _make_sample_hook(cfg, args, device, writes: bool = True):
    """``sample_hook(state, step)``: generate on the first (up to) 4 test
    pairs and write A | output | B columns to OUT/samples/%07d.png and the
    gallery; None when the dataset has no test split, or for a conditional
    experiment, whose test split has no labels. The served copy of G gets
    the state's weights gathered (a collective over G's tensor group, whose
    ranks all run the hook); only a hook with ``writes`` writes."""
    from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
    from tfcgan_tpu_torch.evaluation.gallery import write_gallery
    from tfcgan_tpu_torch.evaluation.suite import save_image_grid
    from tfcgan_tpu_torch.infer import Inferencer
    from tfcgan_tpu_torch.parallel.tensor import full_state_dict

    if cfg.loss.conditional:
        # the JAX hook's test batch has no labels, so its Inferencer
        # conditions the samples on (0, 0, 0); no labelled test set is read here
        if writes:
            print(f"\nsample grids off: {cfg.name!r} is conditional and the test split has "
                  "no labels")
        return None
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
            with without_draws():  # the state's weights are loaded next
                serve.append(_serve_constructor(cfg)(cfg, device))
        serve[0].load_state_dict(full_state_dict(state.G))
        if not writes:
            return
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
    from tfcgan_tpu_torch.data.pairs import (PairedImageDataset, batch_iterator,
                                             load_annotations_csv)
    from tfcgan_tpu_torch.data.prefetch import device_prefetch
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.checkpoint import AsyncCheckpointManager, restore_checkpoint
    from tfcgan_tpu_torch.train.log import JsonlLogger
    from tfcgan_tpu_torch.train.profiling import count_params
    from tfcgan_tpu_torch.train.state import ReduceLROnPlateau, set_learning_rate
    from tfcgan_tpu_torch.train.trainer import Trainer

    device = _device(args.device)
    cfg = _cfg_from_args(args)
    mesh = _data_mesh(device, cfg.mesh)
    lead = mesh is None or mesh.rank == 0  # logs, samples, histograms, checkpoints
    if cfg.loss.conditional and not args.annots:
        raise SystemExit(f"experiment {cfg.name!r} is conditional: pass its labels with "
                         "--annots CSV (columns file, gender, ethnicity, age)")
    roots = [cfg.data.root, *(args.extra_root or cfg.data.extra_roots or [])]
    roots = [r for r in roots if r]
    if cfg.extra.get("needs_extra_root") and len(roots) < 2:
        raise SystemExit(
            f"experiment {cfg.name!r} trains a balanced two-dataset mixture "
            f"(favtgan_..._TripTemp_ED.py:349-374): pass the second dataset "
            f"via --extra-root <path>")
    labels = None
    if cfg.loss.conditional:
        labels = load_annotations_csv(args.annots, label_cols=(1, 2, 3))
    recipe = build_recipe(cfg, device)
    if getattr(recipe, "variant", None) in ("label", "hybrid"):
        raise SystemExit(f"experiment {cfg.name!r} trains on class labels, which the port's "
                         "loader does not read yet")
    datasets = [PairedImageDataset(r, "train", cfg.data.image_size, cfg.data.direction,
                                   labels=labels) for r in roots]
    # kept local, as in the JAX CLI: the closed-form schedules see
    # cfg.train.steps_per_epoch (None -> 1), not the dataset's
    steps_per_epoch = min(len(d) for d in datasets) // cfg.data.batch_size
    logger = JsonlLogger(os.path.join(cfg.train.log_dir, f"{cfg.name}.jsonl")) if lead else None
    trainer = Trainer(cfg, recipe, logger=logger, mesh=mesh)
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

            pool = DevicePool(datasets[0], device, log_every=500 if lead else 0, mesh=mesh)
            it = pool.index_batches(cfg.data.batch_size, seed=cfg.train.seed)
            staged = True
        elif cfg.data.num_workers > 0:
            from tfcgan_tpu_torch.data.prefetch import PrefetchLoader

            if est < (2 << 30):  # decode once, serve later epochs from RAM
                datasets[0].enable_cache()
            loader = PrefetchLoader(datasets[0], cfg.data.batch_size,
                                    num_workers=cfg.data.num_workers, seed=cfg.train.seed,
                                    raw=True, mesh=mesh)
            it = device_prefetch(iter(loader), device, via_uint8=True)
            staged = True
        else:
            it = batch_iterator(datasets[0], cfg.data.batch_size, seed=cfg.train.seed)
    first = next(it)
    state = trainer.init_state(cfg.train.seed, draw=not args.resume)
    if lead:
        world = "" if mesh is None else (f" | world {mesh.world_size}: data {mesh.data_size} "
                                         f"x spatial {mesh.spatial_size} x tensor "
                                         f"{mesh.tensor_size}")
        print(f"G params: {count_params(state.G):,} | D params: {count_params(state.D):,} | "
              f"device: {device}{world}")
    if args.resume:
        # the data order restarts: `first` was drawn and is not stepped
        state = restore_checkpoint(args.resume, state)
        if mesh is not None:  # every rank restored the whole state: keep this rank's slices
            from tfcgan_tpu_torch.parallel import place_state

            place_state(state, mesh)
        if lead:
            print(f"resumed from {args.resume} at step {state.step}")
    else:
        state = trainer.fit(state, [first], pool=pool)  # step 0

    # on a tensor mesh the ranks of rank 0's tensor group gather G with it
    hook_ranks = lead or (mesh.tensor is not None and mesh.leads_tensor_group)
    sample_hook = _make_sample_hook(cfg, args, device, writes=lead) if hook_ranks else None
    hist_logger = None
    if args.hist_every and lead:
        from tfcgan_tpu_torch.train.histograms import HistogramLogger

        hist_logger = HistogramLogger(os.path.join(args.out_dir or ".", "hists.jsonl"))
    ckpt_mgr = AsyncCheckpointManager(cfg.train.checkpoint_dir, mesh=mesh)
    # metric-driven lr (NeMAR 'plateau'): stepped once an epoch on loss_G; a
    # resume starts a fresh controller, as the JAX CLI does
    plateau = ReduceLROnPlateau(cfg.optim.lr) if cfg.optim.schedule == "plateau" else None
    if not staged:
        if mesh is not None:  # host batches are global: each rank places its data share
            from tfcgan_tpu_torch.parallel import local_rows, local_share

            it = (local_rows({k: np.asarray(v)[local_share(len(v), mesh)]
                              for k, v in b.items()}, mesh) for b in it)
        it = device_prefetch(it, device)  # copies overlap the running step
    for epoch in range(cfg.train.n_epochs):
        state = trainer.fit(state, it, num_steps=steps_per_epoch, check_finite=True,
                            sample_hook=sample_hook, hist_logger=hist_logger,
                            hist_every=args.hist_every, pool=pool)
        if plateau is not None and trainer.last_metrics is not None:
            set_learning_rate(state, plateau.step(float(trainer.last_metrics["loss_G"])))
        if cfg.train.checkpoint_interval > 0 and epoch % cfg.train.checkpoint_interval == 0:
            path = ckpt_mgr.save(state)  # the write overlaps the next epoch
            if lead:
                print(f"\n[epoch {epoch}] checkpoint -> {path}")
    ckpt_mgr.save(state)
    ckpt_mgr.close()
    if logger is not None:
        logger.close()
    if hist_logger is not None:
        from tfcgan_tpu_torch.train.histograms import write_histogram_html

        hist_logger.close()
        print(f"\nhistograms -> {write_histogram_html(hist_logger.path)}")
    if mesh is not None and lead:
        import json

        from tfcgan_tpu_torch.ops.kernels import launch_counts

        print("\ndata-parallel run: " + json.dumps({
            "world": mesh.world_size, "mesh": mesh.shape, "steps": state.step,
            "grad_allreduces": trainer.stats.grad_allreduces,
            "flat_buffer_bytes": trainer.stats.flat_bytes,
            "kernel_launches": launch_counts()}))
    _leave_mesh(mesh)


def _serve_weights(args, cfg, device) -> torch.nn.Module:
    """The served module with the weights of --checkpoint, --params or
    --init-seed (exactly one)."""
    from tfcgan_tpu_torch import bridge
    from tfcgan_tpu_torch.train.checkpoint import load_generator_state

    if sum(w is not None for w in (args.checkpoint, args.params, args.init_seed)) != 1:
        raise SystemExit("pass exactly one of --checkpoint DIR, --params g_params.npz and "
                         "--init-seed N")
    if args.init_seed is not None:
        return _serve_constructor(cfg)(cfg, device, torch.Generator().manual_seed(args.init_seed))
    with without_draws():  # the file's weights are loaded next
        module = _serve_constructor(cfg)(cfg, device)
    if args.checkpoint is not None:
        module.load_state_dict(load_generator_state(args.checkpoint))
    elif args.params is not None:
        npz = {"tfcgan": bridge.load_generator_npz, "stn": bridge.load_stn_generators_npz,
               "nemar": bridge.load_nemar_generators_npz,
               "diffusion": bridge.load_diffusion_generators_npz,
               "cyclegan": bridge.load_cyclegan_generators_npz,
               "thermalgan": bridge.load_thermalgan_generators_npz}[cfg.recipe]
        module.load_state_dict(npz(args.params))
    return module


def cmd_test(args):
    from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
    from tfcgan_tpu_torch.infer import Inferencer

    device = _device(args.device)
    cfg = _cfg_from_args(args)
    mesh = _data_mesh(device, cfg.mesh)
    if cfg.recipe == "diffusion":
        raise SystemExit("test serves the GAN recipes; use gen for a diffusion experiment")
    if cfg.loss.conditional:
        raise SystemExit(f"experiment {cfg.name!r} is conditional and the test split has no "
                         "labels: serve it through infer.Inferencer with a batch's LAB3")
    g = _serve_weights(args, cfg, device)
    ds = PairedImageDataset(cfg.data.root, "test", cfg.data.image_size, cfg.data.direction)
    # drop_last=False: every test image is served
    batches = batch_iterator(ds, args.batch_size or 8, shuffle=False, epochs=1, drop_last=False)
    inferencer = Inferencer(cfg, g, mesh=mesh)
    n = inferencer.run_test_set(batches, args.out_dir, save_spectra=args.spectra)
    if inferencer.writes:
        print(f"wrote {n} stacks to {args.out_dir}")
    _leave_mesh(mesh)


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
    from tfcgan_tpu_torch.data.prep import crop_stacks

    n = crop_stacks(args.stack_dir, args.out_root, args.roles.split(","))
    print(f"cropped {n} stacks -> {args.out_root}")


def cmd_prep_combine(args):
    from tfcgan_tpu_torch.data.prep import combine_a_and_b

    n = combine_a_and_b(args.dir_a, args.dir_b, args.dir_ab)
    print(f"combined {n} pairs -> {args.dir_ab}")


def cmd_prep_morphs(args):
    """1 - the morphological gradient of every PNG of --in-dir (the map the
    STN's morph triplet trains on), computed on --device, for comparing the
    edge structure of registered and unregistered images by eye."""
    from tfcgan_tpu_torch.evaluation.suite import _read_rgb, to_uint8, write_png
    from tfcgan_tpu_torch.ops.morphology import morphological_gradient

    device = _device(args.device)
    d127 = torch.tensor(127.5, device=device)  # a true division on CUDA too
    os.makedirs(args.out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(args.in_dir) if f.endswith(".png"))
    for f in files:
        img = torch.from_numpy(np.array(_read_rgb(os.path.join(args.in_dir, f))[None])).to(device)
        m = 1.0 - morphological_gradient(img.float() / d127 - 1.0)
        write_png(os.path.join(args.out_dir, f), to_uint8(m[0].cpu().numpy()))
    print(f"morph plots for {len(files)} images -> {args.out_dir}")


def _print_means(table: dict) -> None:
    for key, values in table.items():
        if key != "file":
            print(f"{key:<12} {np.mean(values):.6f}")


def cmd_eval(args):
    from tfcgan_tpu_torch.evaluation.suite import _load_dir, evaluate_dirs, write_csv

    table = evaluate_dirs(args.fake_dir, args.real_dir, None, _device(args.device))
    if args.iqa:
        # the reference protocol's NR-IQA stage: a score an image of both dirs
        from tfcgan_tpu_torch.evaluation.iqa import compute_iqa

        metrics = tuple(m.strip() for m in args.iqa.split(","))
        for tag, d in (("fake", args.fake_dir), ("real", args.real_dir)):
            for m, v in compute_iqa(list(_load_dir(d)[1]), metrics).items():
                table[f"{m}_{tag}"] = v.tolist()
    if args.out_csv:
        write_csv(table, args.out_csv)
    _print_means(table)


def cmd_eval_reg(args):
    """SSIM, NCC and MI of real_A against real_B (before) and against reg_B
    (after), over three directories matched by sort order."""
    from tfcgan_tpu_torch.evaluation.suite import (_load_dir, difference_plot,
                                                   registration_metrics, write_csv)

    device = _device(args.device)
    (files, a), (fb, b), (fr, rb) = (_load_dir(d) for d in (args.real_a_dir, args.real_b_dir,
                                                            args.reg_b_dir))
    if not len(files) == len(fb) == len(fr):
        raise SystemExit(f"directory size mismatch: real_A={len(files)} real_B={len(fb)} "
                         f"reg_B={len(fr)}")
    a, b, rb = (x / 127.5 - 1.0 for x in (a, b, rb))
    table = {"file": files}
    table.update({k: v.cpu().tolist() for k, v in registration_metrics(
        *(torch.from_numpy(x).to(device) for x in (a, b, rb))).items()})
    if args.out_csv:
        write_csv(table, args.out_csv)
    if args.plots_dir:
        for i, f in enumerate(files):
            difference_plot(a[i], b[i], rb[i],
                            os.path.join(args.plots_dir, f"{os.path.splitext(f)[0]}.png"))
        print(f"difference plots -> {args.plots_dir}")
    _print_means(table)


def cmd_gallery(args):
    from tfcgan_tpu_torch.evaluation.gallery import write_gallery

    print(f"gallery -> {write_gallery(args.dir, title=args.title)}")


def cmd_mesh(args):
    from tfcgan_tpu_torch.evaluation.face_mesh import overlay_directory

    n = overlay_directory(args.src_dir, args.out_dir)
    print(f"annotated {n} faces -> {args.out_dir}")


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
                        help="train: the labels CSV of the conditional (debiased) experiments "
                             "fft_patch_debiased_v1 ... _v6 and fft_patch_debiased, required "
                             "there and ignored elsewhere; a header row, then columns file, "
                             "gender, ethnicity, age")
    common.add_argument("--device", default="cuda")
    common.add_argument("--spatial", type=int, default=None,
                        help="under torchrun: ranks on the mesh's spatial axis (each holds "
                             "its rows of every image; train: the fft_glo family, the stn "
                             "family, tfc_diff, nemar, cyclegan and thermalgan; test), "
                             "default the experiment's "
                             "cfg.mesh.spatial")
    common.add_argument("--tensor", type=int, default=None,
                        help="under torchrun: ranks on the mesh's tensor axis (each holds "
                             "its slice of every sharded weight; train and test), default "
                             "the experiment's cfg.mesh.tensor")

    sp = sub.add_parser("train", parents=[common], help="train an experiment")
    sp.add_argument("--experiment", "--config", dest="experiment", default="fft_glo")
    sp.add_argument("--resume", default=None, help="checkpoint directory to resume from")
    sp.add_argument("--hist-every", type=int, default=0,
                    help="log weight and gradient histograms every N steps of an epoch's "
                         "loop to <out-dir>/hists.jsonl, rendered to hists.html at the end "
                         "(0: off)")
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

    # the host-side commands; --device is the JAX CLI's --cpu
    host = argparse.ArgumentParser(add_help=False)
    host.add_argument("--device", default="cuda",
                      help="where eval, eval-reg and prep-morphs compute (cpu: the JAX "
                           "CLI's --cpu); the other host commands take it and ignore it")

    sp = sub.add_parser("eval", parents=[host])
    sp.add_argument("--fake-dir", required=True)
    sp.add_argument("--real-dir", required=True)
    sp.add_argument("--out-csv", default=None)
    sp.add_argument("--iqa", default=None, metavar="METRICS",
                    help="comma-separated NR-IQA metrics over both dirs (niqe, maniqa, dbcnn)")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("prep-morphs", parents=[host])
    sp.add_argument("--in-dir", required=True)
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_prep_morphs)

    sp = sub.add_parser("eval-reg", parents=[host])
    sp.add_argument("--real-a-dir", required=True)
    sp.add_argument("--real-b-dir", required=True)
    sp.add_argument("--reg-b-dir", required=True)
    sp.add_argument("--out-csv", default=None)
    sp.add_argument("--plots-dir", default=None,
                    help="write 5-panel before/after difference plots (needs matplotlib)")
    sp.set_defaults(fn=cmd_eval_reg)

    sp = sub.add_parser("prep-combine", parents=[host])
    sp.add_argument("--dir-a", required=True)
    sp.add_argument("--dir-b", required=True)
    sp.add_argument("--dir-ab", required=True)
    sp.set_defaults(fn=cmd_prep_combine)

    sp = sub.add_parser("prep-crop", parents=[host])
    sp.add_argument("--stack-dir", required=True)
    sp.add_argument("--out-root", required=True)
    sp.add_argument("--roles", default="real_A,fake_B,real_B")
    sp.set_defaults(fn=cmd_prep_crop)

    sp = sub.add_parser("mesh", parents=[host], help="face-landmark overlays (needs mediapipe)")
    sp.add_argument("--src-dir", required=True)
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_mesh)

    sp = sub.add_parser("gallery", parents=[host], help="index.html over a sample or eval dir")
    sp.add_argument("--dir", required=True)
    sp.add_argument("--title", default=None)
    sp.set_defaults(fn=cmd_gallery)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
