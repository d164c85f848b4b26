"""Spawned ranks for the port's data-parallel and pipeline tests.

``spawn(name, world, tmp_path, **kw)`` starts ``world`` processes, each of
which joins a gloo group through a ``file://`` store under ``tmp_path`` (no
port is shared between parallel test workers), sets torch to one thread, and
calls the function ``name`` of this module as ``fn(rank, world, **kw)``. The
results come back in rank order. A group times out after 60 s, and the
parent kills every rank that outlives its deadline, so a hung collective
fails its test instead of stopping the suite. A rank's error is raised in
the parent with its traceback. Each spawn runs several checks, so that the
start-up is paid once.

This module imports no JAX: the ranks run the port only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing as mp
import queue
import time
import traceback
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist


def shared(tmp_path_factory, key: str, fn):
    """``fn(tmp)`` computed once for the whole test run, ``tmp`` a fresh
    directory: under pytest-xdist the first worker that asks computes it
    under a lock and saves it beside the workers' temporary directories
    (pytest-xdist's documented ``FileLock`` recipe), and the others load it,
    so that a module-scoped fixture whose tests went to several workers
    spawns its ranks once."""
    import os

    from filelock import FileLock

    tmp = tmp_path_factory.mktemp(key)
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return fn(tmp)
    path = tmp_path_factory.getbasetemp().parent / f"{key}.pt"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            return torch.load(path, weights_only=False)
        out = fn(tmp)
        torch.save(out, path)
    return out


def _main(name, rank, world, store, results, kw):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
        results.put((rank, "ok", globals()[name](rank, world, **kw)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(name: str, world: int, tmp_path, deadline: float = 150.0, **kw) -> list:
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # a store file of its own for every spawn: a second spawn of one name in
    # one test must not read the first's keys, which a rank killed at its
    # deadline leaves behind
    store = tmp_path / f"store_{name}_{world}_{time.monotonic_ns()}"
    procs = [ctx.Process(target=_main, args=(name, r, world, str(store), results, kw),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    end = time.monotonic() + deadline
    try:
        while len(got) < world:
            try:
                rank, status, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"{name}: rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]} and no result")
                if time.monotonic() > end:
                    raise TimeoutError(f"{name}: {world - len(got)} rank(s) still running "
                                       f"after {deadline} s") from None
                continue
            if status == "error":
                raise RuntimeError(f"{name}: rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=max(0.1, min(10.0, end - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


# ------------------------------------------------------------------ helpers
def checksum(modules) -> float:
    """A float64 sum over every parameter and buffer of the modules (or
    state dicts), weighted by position (equal on two replicas only if their
    tensors are equal, in practice)."""
    total = 0.0
    for m in modules:
        for i, t in enumerate((m if isinstance(m, dict) else m.state_dict()).values()):
            t = t.detach().double().reshape(-1)
            total += float((t * torch.linspace(1, 2, t.numel(), dtype=torch.float64)).sum()) * (i + 1)
    return total


def _mesh(tensor=1, spatial=1):
    from tfcgan_tpu_torch.parallel import make_mesh

    return make_mesh(spatial=spatial, tensor=tensor, device="cpu")


def _full_checksum(modules) -> float:
    """``checksum`` of the modules' unsharded state (every rank of a tensor
    group calls it: the slices are gathered)."""
    from tfcgan_tpu_torch.parallel.tensor import full_state_dict

    return checksum([full_state_dict(m) for m in modules])


@contextlib.contextmanager
def _float64():
    """float64 as torch's default dtype and every recipe's compute dtype
    inside the block."""
    from tfcgan_tpu_torch.recipes import cyclegan, diffusion, nemar, stn, tfcgan, thermalgan

    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with contextlib.ExitStack() as stack:
            for module in (tfcgan, stn, diffusion, nemar, cyclegan, thermalgan):
                stack.enter_context(mock.patch.object(module, "_dtype",
                                                      lambda cfg: torch.float64))
            yield
    finally:
        torch.set_default_dtype(before)


def _load_modules(recipe, path) -> None:
    saved = torch.load(path, weights_only=True)
    for name, sd in saved.items():
        getattr(recipe, name).load_state_dict(sd)


def _grads(module) -> dict[str, torch.Tensor]:
    return {k: p.grad.detach().clone() for k, p in module.named_parameters()
            if p.grad is not None}


def _batches(batch_size, size, seeds):
    from tfcgan_tpu_torch.data.synth import synthetic_batch

    return [synthetic_batch(batch_size, size, seed=s) for s in seeds]


# ------------------------------------------------------------------ workers
def fftglo_steps(rank, world, cfg, modules=None, draws=None, steps=1, seed=1, save_at=None,
                 tmp=None, batch_seeds=None, tensor=1, resume=None, spatial=1, float64=False):
    """fft_glo steps on one global batch a step. ``modules`` (a torch.save of
    G, D and LPIPS state dicts) and ``draws`` (the step draws as numpy) start
    from the caller's weights and draws; otherwise the port's init from
    ``seed`` and its own draws, or the checkpoint ``resume``. ``tensor`` > 1
    and ``spatial`` > 1 run on a (data[, spatial][, tensor]) mesh;
    ``float64`` builds the modules and runs the steps in float64 (the
    recipe's compute dtype and torch's default; the images stay float32
    values), and tags the saved gradients ``_f64``. Rank 0
    saves the first step's reduced G and D gradients (gathered) to
    ``tmp``/g_grads_{world}.pt and d_grads_{world}.pt; with ``save_at`` (a
    step count or a tuple of them) the ranks save a checkpoint to
    ``tmp``/ckpt_{world} once the state is at that step, a restored one
    before its first step too (rank 0 writes). Returns the
    metrics a step, a checksum of the (gathered) replica after each step, and
    the shapes of G's ``down1.conv`` weight and its Adam moments on this rank
    before and after the steps, and the count of layers that ran on the
    whole map on a spatial mesh."""
    from tfcgan_tpu_torch.parallel import place_state, spatial as spatial_axis
    from tfcgan_tpu_torch.parallel.tensor import full_tensors
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.recipes.tfcgan import StepDraws
    from tfcgan_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from tfcgan_tpu_torch.train.trainer import Trainer

    if float64:
        with _float64():
            return fftglo_steps(rank, world, cfg, modules, draws, steps, seed, save_at, tmp,
                                batch_seeds, tensor, resume, spatial)
    mesh = _mesh(tensor, spatial) if world > 1 else None
    recipe = build_recipe(cfg, "cpu")
    draw_fn = None
    replicated = spatial_axis.REPLICATED_LAYERS
    if draws is not None:
        def draw_fn(state, batch):
            assert batch["A"].shape[0] == cfg.data.batch_size  # the global batch's shape
            return StepDraws(torch.from_numpy(draws["neg"]).long(),
                             torch.from_numpy(draws["factors"]), draws["order"], None)
    trainer = Trainer(cfg, recipe, draw_fn=draw_fn, mesh=mesh)
    fresh = modules is None and resume is None
    state = trainer.init_state(seed, draw=fresh)
    if modules is not None:
        _load_modules(recipe, modules)
    if resume is not None:
        restore_checkpoint(resume, state)
    if not fresh and mesh is not None:
        place_state(state, mesh)

    def shapes():
        p = state.G.down1.conv.weight
        moments = state.opt_g.state.get(p, {})
        return [tuple(p.shape)] + [tuple(moments[k].shape) for k in ("exp_avg", "exp_avg_sq")
                                   if k in moments]

    saves = save_at if isinstance(save_at, tuple) else (save_at,)
    if resume is not None and state.step in saves:
        save_checkpoint(f"{tmp}/ckpt_{world}", state, mesh)
    before = shapes()
    seeds = batch_seeds or list(range(steps))
    metrics, sums = [], []
    for i, batch in enumerate(_batches(cfg.data.batch_size, cfg.data.image_size, seeds)):
        m = trainer.step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        sums.append(_full_checksum([state.G, state.D]))
        if i == 0 and tmp is not None:
            grads = full_tensors(state.G, _grads(state.G))
            d_grads = full_tensors(state.D, _grads(state.D))
            if rank == 0:
                tag = f"{world}{'_f64' if torch.get_default_dtype() == torch.float64 else ''}"
                torch.save(grads, f"{tmp}/g_grads_{tag}.pt")
                torch.save(d_grads, f"{tmp}/d_grads_{tag}.pt")
        if state.step in saves:
            save_checkpoint(f"{tmp}/ckpt_{world}", state, mesh)
    return {"metrics": metrics, "sums": sums, "shapes": (before, shapes()),
            "allreduces": trainer.stats.grad_allreduces, "bytes": trainer.stats.flat_bytes,
            "replicated": spatial_axis.REPLICATED_LAYERS - replicated}


def batchnorm_and_saliency(rank, world, x, w, b, img, tensor=1):
    """``TrainBatchNorm`` and the saliency mask on this rank's share of the
    global inputs inside ``loss_mesh``: outputs and input gradients (of the
    sum of the outputs times a fixed weight), gathered to the whole batch;
    and the batch norm with the local moments (outside the mesh). With
    ``tensor`` > 1 on a (data, tensor) mesh: the shares and the collectives
    are the data axis's."""
    from tfcgan_tpu_torch.models.thermalgan import TrainBatchNorm
    from tfcgan_tpu_torch.ops.saliency import saliency_mask
    from tfcgan_tpu_torch.parallel import all_gather_batch, local_part, loss_mesh

    mesh = _mesh(tensor)
    bn = TrainBatchNorm(x.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    out = {}
    for key, fn, inp in (("bn", bn, x), ("saliency", saliency_mask, img)):
        xl = local_part(torch.from_numpy(inp), mesh).requires_grad_(True)
        with loss_mesh(mesh):
            y = fn(xl)
        whole = (y.shape[0] * mesh.data_size, *y.shape[1:])  # the global cotangent, cut
        cot = local_part(torch.linspace(-1, 1, int(np.prod(whole))).reshape(whole), mesh)
        (y * cot).sum().backward()
        out[key] = (all_gather_batch(y.detach(), mesh).numpy(),
                    all_gather_batch(xl.grad, mesh).numpy())
        if key == "bn":
            out["bn_param_grads"] = (bn.weight.grad.clone(), bn.bias.grad.clone())
            dist.all_reduce(out["bn_param_grads"][0], group=mesh.data_group)
            dist.all_reduce(out["bn_param_grads"][1], group=mesh.data_group)
            out["bn_param_grads"] = tuple(g.numpy() for g in out["bn_param_grads"])
            with torch.no_grad():
                out["bn_local"] = all_gather_batch(bn(xl.detach()), mesh).numpy()
    out["collectives"] = _collectives(mesh.data_rank, mesh)
    out["data_rank"] = mesh.data_rank
    return out


def _collectives(rank, mesh):
    """Each collective's value and input gradient on a small tensor, the
    upstream gradient scaled by the data rank ``rank`` + 1 (so that the sum
    over the two data shares, 3, shows in the backward)."""
    from tfcgan_tpu_torch.parallel import (all_gather_batch, all_reduce_max, all_reduce_min,
                                           all_reduce_sum)

    out = {}
    for name, fn in (("sum", all_reduce_sum), ("gather", all_gather_batch),
                     ("max", all_reduce_max), ("min", all_reduce_min)):
        v = (torch.arange(6.0).reshape(3, 2) + 10 * rank).requires_grad_(True)
        y = fn(v, mesh)
        w = torch.arange(1.0, y.numel() + 1).reshape(y.shape)
        ((y * w).sum() * (rank + 1)).backward()
        out[name] = (y.detach().numpy(), v.grad.numpy())
    return out


def cyclegan_steps(rank, world, cfg, steps, seed=4, prefill=None, save_at=None, tmp=None,
                   resume=None):
    """CycleGAN steps on global batches ``synthetic_batch(seed=i)``, from the
    port's init from ``seed`` with all but ``prefill`` slots of both buffers
    filled (or from the checkpoint ``resume``), the buffers' slots forced to
    collide (every other image into slot 3 once the buffer is full); a
    checkpoint after step ``save_at`` (rank 0 writes). After each step: the
    metrics, both buffers and a checksum of the replica."""
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.recipes.cyclegan import BUFFER_SIZE
    from tfcgan_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from tfcgan_tpu_torch.train.trainer import Trainer

    mesh = _mesh() if world > 1 else None
    recipe = build_recipe(cfg, "cpu")

    def draw_fn(state, batch):
        d = recipe.draw(state.generator, batch)
        d.slots_a[::2] = 3
        d.slots_b[1::2] = 3
        return d

    trainer = Trainer(cfg, recipe, draw_fn=draw_fn, mesh=mesh)
    state = trainer.init_state(seed, draw=resume is None)
    if resume is not None:
        restore_checkpoint(resume, state)
    elif prefill is not None:
        rng = np.random.RandomState(seed)
        size = cfg.data.image_size
        for buf in state.extra.values():
            buf["data"][:BUFFER_SIZE - prefill] = torch.from_numpy(
                rng.uniform(-1, 1, (BUFFER_SIZE - prefill, size, size, 3)).astype(np.float32))
            buf["count"].fill_(BUFFER_SIZE - prefill)
    out = []
    for i in range(state.step, state.step + steps):
        batch = _batches(cfg.data.batch_size, cfg.data.image_size, [i])[0]
        m = trainer.step(state, batch)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "buffers": {k: (v["data"].numpy().copy(), int(v["count"]))
                                for k, v in state.extra.items()},
                    "sum": checksum([state.G, state.D])})
        if save_at is not None and state.step == save_at:
            save_checkpoint(f"{tmp}/ckpt_{world}", state, mesh)
    return out


def pipeline_checks(rank, world, params, x, microbatches, stages, lr=0.05):
    """The GPipe trunk of ``ResidualBlock``s (``params``: one dict of numpy
    leaves a block, the port's names) over ``stages`` ranks: its output, the
    gradients of sum(y²) to the input and to every block's parameters, and
    the loss before and after one SGD step of mean((y - 0.5)²)."""
    from tfcgan_tpu_torch.parallel import make_pipe_mesh, resnet_trunk_pipeline

    mesh = make_pipe_mesh(stages, device="cpu")
    block = trunk_block(params)

    def apply(p, h):
        return torch.func.functional_call(block, p, (h,))

    def leaves():
        return [{k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
                for p in params]

    ps, xt = leaves(), torch.from_numpy(x).requires_grad_(True)
    y = resnet_trunk_pipeline(apply, ps, xt, mesh=mesh, microbatches=microbatches)
    y.square().sum().backward()
    out = {"y": y.detach().numpy(), "gx": xt.grad.numpy(),
           "gp": [{k: v.grad.numpy() for k, v in p.items()} for p in ps]}

    def loss(ps):
        return (resnet_trunk_pipeline(apply, ps, torch.from_numpy(x), mesh=mesh,
                                      microbatches=microbatches) - 0.5).square().mean()

    ps = leaves()
    l0 = loss(ps)
    l0.backward()
    stepped = [{k: (v - lr * v.grad).detach() for k, v in p.items()} for p in ps]
    out["descent"] = (float(l0.detach()), float(loss(stepped).detach()))
    return out


def trunk_block(params):
    """The ``ResidualBlock`` whose parameters ``params[i]`` fill."""
    from tfcgan_tpu_torch.models.layers import without_draws
    from tfcgan_tpu_torch.models.resnet_gen import ResidualBlock

    with without_draws():
        return ResidualBlock(params[0]["conv1.weight"].shape[0])



def mesh_from_config(rank, world, tensor):
    """The mesh that ``Trainer`` builds from ``cfg.mesh.tensor`` alone."""
    import types

    from tfcgan_tpu_torch.config import get_experiment
    from tfcgan_tpu_torch.train.trainer import Trainer

    cfg = get_experiment("fft_glo")
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, tensor=tensor))
    mesh = Trainer(cfg, types.SimpleNamespace(device=torch.device("cpu"))).mesh
    return {"axis_names": mesh.axis_names, "shape": mesh.shape,
            "data": (mesh.data_rank, mesh.data_size), "tensor": (mesh.tensor.rank, mesh.tensor.size),
            "world": (mesh.rank, mesh.world_size)}


def family_steps(rank, world, cfgs, tensor=1, seed=3):
    """One step of each config in ``cfgs`` (name -> config) from the port's
    init from ``seed``, on ``synthetic_batch(seed=0, with_labels=True)``,
    with the recipe's own draws; under ``world`` > 1 on a (data, tensor)
    mesh of ``tensor`` tensor ranks. Returns each step's metrics and the
    number of this rank's parameters that are sharded."""
    from tfcgan_tpu_torch.data.synth import synthetic_batch
    from tfcgan_tpu_torch.parallel.tensor import tensor_dim
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.trainer import Trainer

    mesh = _mesh(tensor) if world > 1 else None
    out = {}
    for name, cfg in cfgs.items():
        trainer = Trainer(cfg, build_recipe(cfg, "cpu"), mesh=mesh)
        state = trainer.init_state(seed)
        batch = synthetic_batch(cfg.data.batch_size, cfg.data.image_size, seed=0,
                                with_labels=True)
        m = trainer.step(state, batch)
        modules = [x for x in (state.G, state.D, state.lpips, state.cnns, state.frozen)
                   if x is not None]
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "sharded": sum(tensor_dim(p) is not None for x in modules
                                    for p in x.parameters())}
    return out


def thermalgan_serve(rank, world, cfg, weights, batch, tensor=1):
    """``Inferencer(mesh=)`` of thermalgan's generators with the state dict
    in the file ``weights`` on ``batch``, on a (data, tensor) mesh. On a
    tensor mesh the generators are sharded first, as a training state's are
    (the Inferencer gathers them). Returns fake_B of the whole batch."""
    from tfcgan_tpu_torch.infer import Inferencer
    from tfcgan_tpu_torch.models.layers import without_draws
    from tfcgan_tpu_torch.parallel.tensor import is_sharded, shard_params
    from tfcgan_tpu_torch.recipes.thermalgan import build_generators

    mesh = _mesh(tensor)
    with without_draws():
        nets = build_generators(cfg, "cpu")
    nets.load_state_dict(torch.load(weights, weights_only=True))
    if mesh.tensor is not None:
        shard_params([nets], mesh.tensor)
        assert is_sharded(nets)
    inf = Inferencer(cfg, nets, mesh=mesh)
    return {"fake_B": inf(batch).numpy(), "writes": inf.writes}


def fit_with_hooks(rank, world, cfg, tmp, tensor=1, seed=3):
    """``Trainer.fit`` over one step with a histogram record (rank 0 writes
    ``tmp``/hists_{world}.jsonl) and a sample hook that gathers G's state,
    under a (data, tensor) mesh as the CLI runs them: rank 0 has the
    histogram logger, the ranks of its tensor group the hook. Returns G's
    whole state as the hook saw it, as numpy (None where it did not run)."""
    from tfcgan_tpu_torch.parallel.tensor import full_state_dict
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.histograms import HistogramLogger
    from tfcgan_tpu_torch.train.trainer import Trainer

    mesh = _mesh(tensor) if world > 1 else None
    trainer = Trainer(cfg, build_recipe(cfg, "cpu"), mesh=mesh)
    state = trainer.init_state(seed)
    seen = []

    def hook(state, step):
        seen.append({k: v.numpy().copy() for k, v in full_state_dict(state.G).items()})

    hist = HistogramLogger(f"{tmp}/hists_{world}.jsonl") if rank == 0 else None
    batch = _batches(cfg.data.batch_size, cfg.data.image_size, [0])[0]
    trainer.fit(state, [batch], hist_logger=hist, hist_every=1, sample_hook=hook, sample_every=1)
    if hist is not None:
        hist.close()
    return seen or None


# ------------------------------------------------------------ spatial axis
SPATIAL_OPS = ("conv", "head", "convT", "upsample", "spectral", "blur1", "blur2", "norm32",
               "norm16", "pool", "conv3", "gather")


def spatial_op(name: str, seed: int = 0):
    """One spatially aware op of the spatial axis, weights drawn from
    ``seed``: (fn(x, rows) -> y, its module or None, the input's channels,
    its dtype). ``rows`` None runs it unsharded."""
    from tfcgan_tpu_torch.models.layers import (SpectralConv, TorchConv, TorchConvTranspose,
                                                Upsample2xConv, without_draws)
    from tfcgan_tpu_torch.ops.blurpool import blur_pool
    from tfcgan_tpu_torch.ops.norm import instance_norm
    from tfcgan_tpu_torch.ops.pooling import pool22
    from tfcgan_tpu_torch.parallel.spatial import gather_spatial, split_rows

    gen = torch.Generator().manual_seed(seed)
    with without_draws():
        module = {"conv": lambda: TorchConv(3, 4),
                  "head": lambda: TorchConv(3, 4, padding=((2, 1), (2, 1)), use_bias=False),
                  "convT": lambda: TorchConvTranspose(3, 4),
                  "upsample": lambda: Upsample2xConv(3, 4),
                  "spectral": lambda: SpectralConv(3, 4),
                  "conv3": lambda: TorchConv(3, 4, kernel_size=3)}.get(name, lambda: None)()
    if module is not None:
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
            if name == "spectral":
                module.u = torch.nn.functional.normalize(torch.randn(4, generator=gen), dim=0)
                module.v = torch.nn.functional.normalize(torch.randn(48, generator=gen), dim=0)
        return (lambda x, rows: module(x, rows)), module, 3, torch.float32
    fns = {"blur1": lambda x, rows: blur_pool(x, 1, rows),
           "blur2": lambda x, rows: blur_pool(x, 2, rows),
           "norm32": lambda x, rows: instance_norm(x, rows=rows),
           "norm16": lambda x, rows: instance_norm(x, rows=rows),
           "pool": lambda x, rows: pool22(x, rows),
           "gather": lambda x, rows: split_rows(gather_spatial(x, rows).flip(1) * 2.0, rows)}
    return fns[name], None, 3, torch.bfloat16 if name == "norm16" else torch.float32


def spatial_op_inputs(name: str, h: int, seed: int = 1):
    """The global input (2, h, 5, C) and output cotangent of ``spatial_op(name)``
    (None where the op has no output at that height)."""
    fn, _, c, dtype = spatial_op(name)
    rng = np.random.RandomState(seed + h)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, h, 5, c)).astype(np.float32)).to(dtype)
    try:
        with torch.no_grad():
            y = fn(x, None)
    except RuntimeError:  # a k4 conv of one row
        return x, None
    cot = torch.from_numpy(rng.uniform(-1, 1, tuple(y.shape)).astype(np.float32)).to(dtype)
    return x, cot


def spatial_op_run(name: str, x, cot, rows):
    """The op on ``x`` (this rank's rows, or the whole map without ``rows``):
    its output, the gradients of sum(y * cot) to x and to the weights."""
    fn, module, _, _ = spatial_op(name)
    x = x.clone().requires_grad_(True)
    y = fn(x, rows)
    (y.float() * cot.float()).sum().backward()
    grads = {} if module is None else {k: p.grad.clone() for k, p in module.named_parameters()}
    return y.detach(), x.grad, grads


def spatial_ops(rank, world, cases):
    """Each (op, h) of ``cases`` on this rank's rows over a spatial mesh of
    the whole world: output, input gradient and weight gradients, and the
    number of layers that ran on the whole map."""
    from tfcgan_tpu_torch.parallel import make_mesh
    from tfcgan_tpu_torch.parallel import spatial

    mesh = make_mesh(spatial=world, device="cpu")
    assert mesh.axis_names == ("data", "spatial") and mesh.spatial.rank == rank
    out = {}
    for name, h in cases:
        x, cot = spatial_op_inputs(name, h)
        rows = mesh.image_rows(h)
        fn = spatial_op(name)[0]
        with torch.no_grad():
            h_out = fn(x, None).shape[1]
        before = spatial.REPLICATED_LAYERS
        y, gx, gw = spatial_op_run(name, rows.cut(x), rows.of(h_out).cut(cot), rows)
        out[name, h] = {"y": y.float().numpy(), "gx": gx.float().numpy(),
                        "gw": {k: v.numpy() for k, v in gw.items()},
                        "replicated": spatial.REPLICATED_LAYERS - before}
    return out



def spatial_serve_and_checkpoint(rank, world, cfg, weights, batch, tmp, train_cfg):
    """On a (1 data x ``world`` spatial) mesh: ``Inferencer(mesh=)`` of the
    fft_glo G with the state dict in the file ``weights`` on ``batch`` (the
    whole batch's fake_B); and ``train_cfg`` one step from the port's init,
    a checkpoint of it (rank 0 writes ``tmp``/ckpt), restored into an
    unplaced state and placed: the checksums of both states' G, D and Adam
    moments, and their steps."""
    from tfcgan_tpu_torch.infer import Inferencer
    from tfcgan_tpu_torch.models.layers import without_draws
    from tfcgan_tpu_torch.parallel import place_state
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.recipes.tfcgan import build_generator
    from tfcgan_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from tfcgan_tpu_torch.train.trainer import Trainer

    mesh = _mesh(spatial=world)
    with without_draws():
        g = build_generator(cfg, "cpu")
    g.load_state_dict(torch.load(weights, weights_only=True))
    inf = Inferencer(cfg, g, mesh=mesh)
    out = {"fake_B": inf(batch).numpy(), "writes": inf.writes}

    def sums(state):
        moments = [t for opt in (state.opt_g, state.opt_d) for st in opt.state.values()
                   for k, t in st.items() if k in ("exp_avg", "exp_avg_sq")]
        return state.step, checksum([state.G, state.D]), checksum([dict(enumerate(moments))])

    trainer = Trainer(train_cfg, build_recipe(train_cfg, "cpu"), mesh=mesh)
    state = trainer.init_state(5)
    trainer.step(state, _batches(train_cfg.data.batch_size, train_cfg.data.image_size, [7])[0])
    path = save_checkpoint(f"{tmp}/ckpt", state, mesh)
    restored = restore_checkpoint(path, Trainer(train_cfg, build_recipe(train_cfg, "cpu"),
                                                mesh=mesh).init_state(0, draw=False))
    place_state(restored, mesh)
    out["saved"], out["restored"] = sums(state), sums(restored)
    return out


def mesh_error(rank, world, spatial, tensor):
    """``make_mesh(spatial=, tensor=)`` in this world: its error's type and message."""
    from tfcgan_tpu_torch.parallel import make_mesh

    try:
        make_mesh(spatial=spatial, tensor=tensor, device="cpu")
    except Exception as e:  # the refusal under test
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------- spatial axis: the STN and TFC-Diff
READERS = ("warp_cubic", "warp_linear_zeros", "direct", "direct_zeros", "group_norm",
           "attention", "upsample")


def spatial_reader(name: str, seed: int = 0):
    """One layer of the STN or diffusion path on row shards, weights drawn
    from ``seed``: (fn(x, theta, rows) -> y, its module or None, the input's
    (W, C)). ``rows`` None runs it on the whole map."""
    from tfcgan_tpu_torch.models.diffusion import AttentionBlock, upsample_nearest2x
    from tfcgan_tpu_torch.ops.norm import group_norm
    from tfcgan_tpu_torch.ops.resample import warp_affine_separable
    from tfcgan_tpu_torch.ops.warp import warp_affine

    gen = torch.Generator().manual_seed(seed)
    if name == "attention":
        module = AttentionBlock(16, groups=4)
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3 + (1.0 if p.dim() == 1 else 0))
        return (lambda x, theta, rows: module(x, rows)), module, (4, 16)
    if name == "group_norm":
        module = torch.nn.Module()
        module.weight = torch.nn.Parameter(1 + 0.3 * torch.randn(8, generator=gen))
        module.bias = torch.nn.Parameter(0.3 * torch.randn(8, generator=gen))
        return (lambda x, theta, rows: group_norm(x, 4, module.weight, module.bias, 1e-5, rows)
                ), module, (5, 8)
    if name == "upsample":
        return (lambda x, theta, rows: upsample_nearest2x(x, rows)), None, (3, 2)
    mode, padding = ("bilinear", "zeros") if name.endswith("zeros") else ("bicubic", "border")
    if name.startswith("warp"):
        return (lambda x, theta, rows: warp_affine_separable(x, theta, mode, padding, rows)
                ), None, (9, 3)
    return (lambda x, theta, rows: warp_affine(x, theta, mode, padding, True, rows)), None, (9, 3)


def spatial_reader_inputs(name: str, h: int, seed: int = 1):
    """The whole input (2, h, W, C), theta (2, 2, 3) and the output cotangent
    of ``spatial_reader(name)``. The two thetas rotate by 0.3 rad and shift,
    and flip the rows: every output row reads rows of other shards."""
    fn, _, (w, c) = spatial_reader(name)
    rng = np.random.RandomState(seed + h)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, h, w, c)).astype(np.float32))
    ang = 0.3
    theta = torch.tensor([[[np.cos(ang) * 0.9, -np.sin(ang), 0.15],
                           [np.sin(ang), np.cos(ang) * 1.1, -0.2]],
                          [[1.05, 0.1, -0.1], [0.05, -0.95, 0.1]]], dtype=torch.float32)
    with torch.no_grad():
        y = fn(x, theta, None)
    cot = torch.from_numpy(rng.uniform(-1, 1, tuple(y.shape)).astype(np.float32))
    return x, theta, cot


def spatial_reader_run(name: str, x, theta, cot, rows):
    """The layer on ``x`` (this rank's rows, or the whole map without
    ``rows``): its output, and the gradients of sum(y * cot) to x, theta and
    the weights."""
    fn, module, _ = spatial_reader(name)
    x = x.clone().requires_grad_(True)
    theta = theta.clone().requires_grad_(True)
    y = fn(x, theta, rows)
    (y * cot).sum().backward()
    grads = {} if module is None else {k: p.grad.clone() for k, p in module.named_parameters()}
    gt = theta.grad if theta.grad is not None else torch.zeros_like(theta)
    return y.detach(), x.grad, gt, grads


def spatial_readers(rank, world, cases):
    """Each (layer, h) of ``cases`` on this rank's rows over a spatial mesh of
    the whole world: output, input and theta gradients, weight gradients."""
    from tfcgan_tpu_torch.parallel import make_mesh

    mesh = make_mesh(spatial=world, device="cpu")
    out = {}
    for name, h in cases:
        x, theta, cot = spatial_reader_inputs(name, h)
        rows = mesh.image_rows(h)
        y, gx, gt, gw = spatial_reader_run(name, rows.cut(x), theta,
                                           rows.of(cot.shape[1]).cut(cot), rows)
        out[name, h] = {"y": y.numpy(), "gx": gx.numpy(), "gt": gt.numpy(),
                        "gw": {k: v.numpy() for k, v in gw.items()}}
    return out


def family_spatial_steps(rank, world, cfg, modules, draws=None, spatial=1, tmp=None,
                         float64=False, seed=0, prefix=""):
    """One step of ``cfg`` from the modules in the file ``modules`` (a
    torch.save of the recipe's G, D[, lpips][, cnns] state dicts) on
    ``synthetic_batch(seed=seed, with_labels=True)``: with ``world`` > 1 on a
    (data x ``spatial``) mesh. ``draws`` (the global step's draws as numpy,
    ``step_draws``) replaces the recipe's draws. Rank 0 saves the reduced G
    gradients to ``tmp``/g_grads_{world}[_f64].pt (D's and the regional
    heads' to d_ and c_grads);
    ``float64`` as in ``fftglo_steps``; ``prefix`` starts the files' names.
    Returns the metrics and the count of layers that ran on the whole map."""
    from tfcgan_tpu_torch.data.synth import synthetic_batch
    from tfcgan_tpu_torch.parallel import place_state, spatial as spatial_axis
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.trainer import Trainer

    if float64:
        with _float64():
            return family_spatial_steps(rank, world, cfg, modules, draws, spatial, tmp,
                                        seed=seed, prefix=prefix)
    mesh = _mesh(spatial=spatial) if world > 1 else None
    recipe = build_recipe(cfg, "cpu")
    draw_fn = None
    if draws is not None:
        def draw_fn(state, batch):
            assert batch["A"].shape[0] == cfg.data.batch_size  # the global batch's shape
            return step_draws(cfg, draws)
    trainer = Trainer(cfg, recipe, draw_fn=draw_fn, mesh=mesh)
    state = trainer.init_state(0, draw=False)
    _load_modules(recipe, modules)
    if mesh is not None:
        place_state(state, mesh)
    replicated = spatial_axis.REPLICATED_LAYERS
    batch = synthetic_batch(cfg.data.batch_size, cfg.data.image_size, seed=seed,
                            with_labels=True)
    metrics = {k: float(v) for k, v in trainer.step(state, batch).items()}
    if tmp is not None and rank == 0:
        tag = f"{world}{'_f64' if torch.get_default_dtype() == torch.float64 else ''}"
        torch.save(_grads(state.G), f"{tmp}/{prefix}g_grads_{tag}.pt")
        if any(True for _ in state.D.parameters()):
            torch.save(_grads(state.D), f"{tmp}/{prefix}d_grads_{tag}.pt")
        if state.cnns is not None and _grads(state.cnns):  # the V4-V6 regional heads
            torch.save(_grads(state.cnns), f"{tmp}/{prefix}c_grads_{tag}.pt")
    return {"metrics": metrics, "replicated": spatial_axis.REPLICATED_LAYERS - replicated}


def step_draws(cfg, draws):
    """The step draws of ``cfg``'s recipe from their numpy form: a diffusion
    step's noise and timesteps, or a tfcgan step's patch negatives
    (``neg``), jitter ``factors`` and ``order`` and the debiased family's
    label and FFT-triplet draws where present (G without dropout)."""
    from tfcgan_tpu_torch.recipes.diffusion import DiffusionStepDraws
    from tfcgan_tpu_torch.recipes.tfcgan import StepDraws

    if cfg.recipe == "diffusion":
        return DiffusionStepDraws(torch.from_numpy(draws["noise"]),
                                  torch.from_numpy(draws["t"]).long(), None)
    ints = {k: torch.from_numpy(draws[k]).long() for k in ("g_labels", "d_fake_labels", "fft_neg")
            if draws.get(k) is not None}
    return StepDraws(torch.from_numpy(draws["neg"]).long(), torch.from_numpy(draws["factors"]),
                     list(draws["order"]), None, **ints)


# ------------------------------- spatial axis: NeMAR, CycleGAN and ThermalGAN
# the layers whose output is a share of a scalar (summed over the ranks)
SHARE_OPS = ("multi", "smooth0", "smooth2")


def baseline_op(name: str, seed: int = 0):
    """One row-aware piece of the NeMAR, CycleGAN and ThermalGAN paths,
    weights drawn from ``seed``: (fn(x, rows) -> y, its module or None, the
    input's (W, C)). ``rows`` None runs it on the whole map."""
    from tfcgan_tpu_torch.models.discriminator import (MultiDiscriminator, NLayerDiscriminator,
                                                       StridedPatchDiscriminator, multiscale_loss)
    from tfcgan_tpu_torch.models.layers import TorchConv, without_draws
    from tfcgan_tpu_torch.models.resnet import BasicBlock
    from tfcgan_tpu_torch.models.resnet_gen import ResNetGenerator, reflect_conv
    from tfcgan_tpu_torch.models.stn import _upsample_to, smoothness_loss
    from tfcgan_tpu_torch.models.thermalgan import (TrainBatchNorm, _avg_pool_8x8, _max_pool_3x3,
                                                    normalized_temps)
    from tfcgan_tpu_torch.ops.gridsample import grid_sample_dense_plain
    from tfcgan_tpu_torch.ops.resize import avg_pool_2x
    from tfcgan_tpu_torch.parallel.spatial import window_op

    gen = torch.Generator().manual_seed(seed)
    no_pad = ((0, 0), (0, 0))
    with without_draws():
        module = {"reflect3": lambda: TorchConv(3, 4, kernel_size=3, padding=no_pad),
                  "reflect7": lambda: TorchConv(3, 4, kernel_size=7, padding=no_pad),
                  "resnet_gen": lambda: ResNetGenerator(3, 3, num_blocks=1, base_feats=4),
                  "nlayer": lambda: NLayerDiscriminator(3, ndf=4),
                  "strided": lambda: StridedPatchDiscriminator(
                      3, head_kernel=4, head_padding=((2, 1), (2, 1))),
                  "multi": lambda: MultiDiscriminator(3),
                  "basic": lambda: BasicBlock(3, 4, stride=2),
                  "bn": lambda: TrainBatchNorm(3)}.get(name, lambda: None)()
    if module is not None:
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3 + (1.0 if p.dim() == 1 else 0))
    up = {"upsample_to": 0, "upsample_odd": 1}

    def upsample(x, rows, extra):
        h = x.shape[1] if rows is None else rows.h
        like = x.new_empty((x.shape[0], 2 * h + extra, 2 * x.shape[2], 1))
        return _upsample_to(x, like, rows, rows and rows.of(2 * h + extra))

    fns = {"reflect3": lambda x, rows: reflect_conv(module, x, 1, rows),
           "reflect7": lambda x, rows: reflect_conv(module, x, 3, rows),
           "multi": lambda x, rows: multiscale_loss(module(x, rows), 0.5, "mse",
                                                    module.out_rows(rows)),
           "avgpool2x": lambda x, rows: avg_pool_2x(x, rows),
           "maxpool3": lambda x, rows: window_op(x, rows, 3, 2, 1, _max_pool_3x3),
           "avg8": lambda x, rows: window_op(x, rows, 8, 8, 0, _avg_pool_8x8),
           "temps": lambda x, rows: normalized_temps(x[..., 0] + 2.0, rows)[..., None],
           "smooth0": lambda x, rows: smoothness_loss(x[..., :2], x[..., 2:], 0.0, rows),
           "smooth2": lambda x, rows: smoothness_loss(x[..., :2], x[..., 2:], 2.0, rows),
           "gridsample": lambda x, rows: grid_sample_dense_plain(
               x[..., :3], 1.1 * x[..., 3:], rows=rows)}
    if name in up:
        fn = lambda x, rows: upsample(x, rows, up[name])  # noqa: E731
    else:
        fn = fns.get(name, lambda x, rows: module(x, rows))
    shape = {"resnet_gen": (12, 3), "nlayer": (32, 3), "strided": (32, 3), "multi": (128, 3),
             "avg8": (16, 3), "smooth0": (6, 5), "smooth2": (6, 5),
             "gridsample": (6, 5)}.get(name, (5, 3))
    return fn, module, shape


def baseline_op_inputs(name: str, h: int, seed: int = 1):
    """The whole input (2, h, W, C) of ``baseline_op(name)`` and the output
    cotangent (a 0-dim one for a share)."""
    fn, _, (w, c) = baseline_op(name)
    rng = np.random.RandomState(seed + h)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, h, w, c)).astype(np.float32))
    with torch.no_grad():
        y = fn(x, None)
    cot = torch.from_numpy(rng.uniform(-1, 1, tuple(y.shape)).astype(np.float32))
    return x, cot


def baseline_op_run(name: str, x, cot, rows):
    """The piece on ``x`` (this rank's rows, or the whole map): its output,
    the gradients of sum(y * cot) to x and to the weights."""
    fn, module, _ = baseline_op(name)
    x = x.clone().requires_grad_(True)
    y = fn(x, rows)
    (y * cot).sum().backward()
    grads = {} if module is None else {k: p.grad.clone() for k, p in module.named_parameters()}
    return y.detach(), x.grad, grads


def baseline_ops(rank, world, cases):
    """Each (piece, h) of ``cases`` on this rank's rows over a spatial mesh of
    the whole world: output, input and weight gradients, and the number of
    layers that ran on the whole map."""
    from tfcgan_tpu_torch.parallel import make_mesh
    from tfcgan_tpu_torch.parallel import spatial

    mesh = make_mesh(spatial=world, device="cpu")
    out = {}
    for name, h in cases:
        x, cot = baseline_op_inputs(name, h)
        rows = mesh.image_rows(h)
        if name not in SHARE_OPS:
            cot = rows.of(cot.shape[1]).cut(cot)
        before = spatial.REPLICATED_LAYERS
        y, gx, gw = baseline_op_run(name, rows.cut(x), cot, rows)
        out[name, h] = {"y": y.numpy(), "gx": gx.numpy(),
                        "gw": {k: v.numpy() for k, v in gw.items()},
                        "replicated": spatial.REPLICATED_LAYERS - before}
    return out


def spatial_jobs(rank, world, jobs, spatial=1, tmp=None):
    """``family_spatial_steps`` for each job of ``jobs`` (a dict of its
    keyword arguments, with ``name``: the prefix of its files and its key in
    the result), in one spawn; only the float64 jobs save their gradients."""
    return {job["name"]: family_spatial_steps(
        rank, world, spatial=spatial, tmp=tmp if job.get("float64") else None,
        prefix=job["name"] + "_", **{k: v for k, v in job.items() if k != "name"})
        for job in jobs}


def _state_sums(state):
    """The step, and digests of the bytes of G and D, of their Adam moments
    and of the recipe-owned buffers: equal only where every tensor is."""
    import hashlib

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    moments = [t for opt in (state.opt_g, state.opt_d) for st in opt.state.values()
               for k, t in st.items() if k in ("exp_avg", "exp_avg_sq")]
    return (state.step, digest([*state.G.state_dict().values(), *state.D.state_dict().values()]),
            digest(moments), digest([v["data"] for v in state.extra.values()]))


def cyclegan_spatial(rank, world, cfg, tmp, spatial=1, other=None, seed=4, prefill=3,
                     only_other=False, resume=True):
    """CycleGAN on a (1 data x ``spatial``) mesh (world 1 without one): two
    steps from the port's init from ``seed`` with all but ``prefill`` buffer
    slots filled and colliding slots (``cyclegan_steps``), a checkpoint after
    step 1 (``tmp``/ckpt_{world}); that checkpoint restored and step 2 run
    again (``resume``); the checkpoint ``other`` (another world's, if given) restored and
    step 2 run from it; and one float64 step, whose gradients rank 0 saves
    to ``tmp``/cyc_{g,d}_grads_{world}_f64.pt (``only_other``: the restore of
    ``other`` alone). Returns each run's metrics, buffers and state
    checksums (``_state_sums``)."""
    from tfcgan_tpu_torch.parallel import place_state
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from tfcgan_tpu_torch.train.trainer import Trainer

    mesh = _mesh(spatial=spatial) if world > 1 else None

    def trainer_of():
        recipe = build_recipe(cfg, "cpu")

        def draw_fn(state, batch):
            d = recipe.draw(state.generator, batch)
            d.slots_a[::2] = 3
            d.slots_b[1::2] = 3
            return d

        return Trainer(cfg, recipe, draw_fn=draw_fn, mesh=mesh)

    def step(trainer, state, i):
        batch = _batches(cfg.data.batch_size, cfg.data.image_size, [i])[0]
        m = trainer.step(state, batch)
        return {"metrics": {k: float(v) for k, v in m.items()},
                "buffers": {k: (v["data"].numpy().copy(), int(v["count"]))
                            for k, v in state.extra.items()},
                "sums": _state_sums(state)}

    def restored(path):
        trainer = trainer_of()
        state = restore_checkpoint(path, trainer.init_state(0, draw=False))
        if mesh is not None:
            place_state(state, mesh)
        return trainer, state

    def fresh():
        trainer = trainer_of()
        state = trainer.init_state(seed)
        rng = np.random.RandomState(seed)
        size = cfg.data.image_size
        for buf in state.extra.values():
            buf["data"][:-prefill] = torch.from_numpy(
                rng.uniform(-1, 1, (buf["data"].shape[0] - prefill, size, size, 3)).astype(
                    np.float32))
            buf["count"].fill_(buf["data"].shape[0] - prefill)
        return trainer, state

    out = {}
    if other is not None:
        trainer, state = restored(other)
        out["other_sums"] = _state_sums(state)
        out["other"] = step(trainer, state, 1)
    if only_other:
        return out
    trainer, state = fresh()
    out["steps"] = []
    for i in range(2):
        out["steps"].append(step(trainer, state, i))
        if state.step == 1:
            save_checkpoint(f"{tmp}/ckpt_{world}", state, mesh)
    if resume:
        trainer, state = restored(f"{tmp}/ckpt_{world}/step_00000001")
        out["resumed"] = step(trainer, state, 1)
    with _float64():
        trainer, state = fresh()
        out["f64"] = step(trainer, state, 0)
        if rank == 0:
            torch.save(_grads(state.G), f"{tmp}/cyc_g_grads_{world}_f64.pt")
            torch.save(_grads(state.D), f"{tmp}/cyc_d_grads_{world}_f64.pt")
    return out



# ------------------------------ spatial axis: the debiased chain's pieces
# the pieces' outputs: row shards ("rows") or whole on every rank ("whole")
DEBIASED_OUTPUTS = {"plane": ("rows",), "aux3": ("rows", "whole", "whole", "whole"),
                    "aux1": ("rows", "whole")}


def debiased_op(name: str, h: int, seed: int = 0):
    """One row-aware piece of the debiased path for h x h images, float64,
    weights drawn from ``seed``: ``ConditionalGeneratorUNet``'s label plane
    (``plane``; only ``label_fc`` is drawn: the inner U-Net is allocated and
    not used) or the ``AuxClassifierDiscriminator`` with three heads
    (``aux3``, V1-V5) or the ethnicity head alone (``aux1``, V6/V7). Returns
    (fn(x, labels, rows) -> outputs, the modules whose gradients count, the
    input's channels)."""
    from tfcgan_tpu_torch.models.discriminator import AuxClassifierDiscriminator
    from tfcgan_tpu_torch.models.layers import without_draws
    from tfcgan_tpu_torch.models.unet import ConditionalGeneratorUNet

    gen = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64)
    if name == "plane":
        with without_draws():
            g = ConditionalGeneratorUNet(3, 3, h, **f64)
        with torch.no_grad():
            for p in g.label_fc.parameters():
                p.copy_(torch.randn(p.shape, generator=gen, dtype=p.dtype))

        def fn(x, labels, rows):
            return (g.label_plane(labels, x.shape[0], h, x.shape[2], rows),)
        return fn, g.label_fc, 3
    heads = (2, 3) if name == "aux3" else (0, 0)
    d = AuxClassifierDiscriminator(6, h, 4, *heads, generator=gen, **f64)
    with torch.no_grad():  # live biases, as a trained D has
        for p in d.parameters():
            if p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen, dtype=p.dtype))

    def fn(x, labels, rows):
        logits, probs = d(x[..., :3], x[..., 3:], rows)
        return (logits, *(probs if isinstance(probs, tuple) else (probs,)))
    return fn, d, 6


def debiased_op_inputs(name: str, h: int, seed: int = 1):
    """The whole inputs of ``debiased_op(name, h)``: images (2, h, h, C) and
    (2, 3) labels, float64, and a cotangent for each output."""
    fn, _, c = debiased_op(name, h)
    rng = np.random.RandomState(seed + h)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, h, h, c)))
    labels = torch.from_numpy(rng.randint(0, 4, (2, 3)).astype(np.float64))
    with torch.no_grad():
        ys = fn(x, labels, None)
    cots = [torch.from_numpy(rng.uniform(-1, 1, tuple(y.shape))) for y in ys]
    return x, labels, cots


def debiased_op_run(name: str, h: int, rows=None, tensor=None):
    """The piece on this rank's rows of the inputs (the whole map without
    ``rows``), its modules sharded over the tensor axis ``tensor`` if given:
    the outputs (the row outputs this rank's rows), and the gradients of
    sum(y * cot), each whole output's term counted 1 / S a rank (the axis's
    rule), to the images' rows and to the weights (sharded ones gathered),
    and the shapes of the weights this rank holds."""
    from tfcgan_tpu_torch.parallel.spatial import replicated_share
    from tfcgan_tpu_torch.parallel.tensor import full_tensors, shard_params

    fn, module, _ = debiased_op(name, h)
    x, labels, cots = debiased_op_inputs(name, h)
    if tensor is not None:
        shard_params([module], tensor)
    if rows is not None:
        x = rows.cut(x)
    x = x.clone().requires_grad_(True)
    ys = fn(x, labels, rows)
    loss = 0.0
    for y, cot, kind in zip(ys, cots, DEBIASED_OUTPUTS[name]):
        if kind == "rows":
            loss = loss + (y * (cot if rows is None else rows.of(cot.shape[1]).cut(cot))).sum()
        else:
            loss = loss + replicated_share((y * cot).sum(), rows)
    loss.backward()
    grads = full_tensors(module, {k: p.grad for k, p in module.named_parameters()})
    gx = torch.zeros_like(x) if x.grad is None else x.grad  # the plane reads no image
    return ([y.detach() for y in ys], gx, {k: v.clone() for k, v in grads.items()},
            {k: tuple(p.shape) for k, p in module.named_parameters()})


def debiased_ops(rank, world, cases, tensor=1):
    """Each (piece, h) of ``cases`` on a (1 data x world / ``tensor``
    spatial x ``tensor``) mesh: this rank's outputs, input and weight
    gradients (``debiased_op_run``), as numpy."""
    mesh = _mesh(tensor=tensor, spatial=world // tensor)
    out = {}
    with _float64():
        for name, h in cases:
            ys, gx, gw, shapes = debiased_op_run(name, h, mesh.image_rows(h), mesh.tensor)
            out[name, h] = {"ys": [y.numpy() for y in ys], "gx": gx.numpy(),
                            "gw": {k: v.numpy() for k, v in gw.items()}, "shapes": shapes}
    return out

