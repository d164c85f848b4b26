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

import dataclasses
import datetime
import multiprocessing as mp
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


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
    store = tmp_path / f"store_{name}_{world}"
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


def _mesh(tensor=1):
    from tfcgan_tpu_torch.parallel import make_mesh

    return make_mesh(tensor=tensor, device="cpu")


def _full_checksum(modules) -> float:
    """``checksum`` of the modules' unsharded state (every rank of a tensor
    group calls it: the slices are gathered)."""
    from tfcgan_tpu_torch.parallel.tensor import full_state_dict

    return checksum([full_state_dict(m) for m in modules])


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
                 tmp=None, batch_seeds=None, tensor=1, resume=None):
    """fft_glo steps on one global batch a step. ``modules`` (a torch.save of
    G, D and LPIPS state dicts) and ``draws`` (the step draws as numpy) start
    from the caller's weights and draws; otherwise the port's init from
    ``seed`` and its own draws, or the checkpoint ``resume``. ``tensor`` > 1
    runs on a (data, tensor) mesh. Rank 0 saves the first step's averaged G
    gradients (gathered) to ``tmp``/g_grads_{world}.pt; with ``save_at`` (a
    step count or a tuple of them) the ranks save a checkpoint to
    ``tmp``/ckpt_{world} once the state is at that step, a restored one
    before its first step too (rank 0 writes). Returns the
    metrics a step, a checksum of the (gathered) replica after each step, and
    the shapes of G's ``down1.conv`` weight and its Adam moments on this rank
    before and after the steps."""
    from tfcgan_tpu_torch.parallel import place_state
    from tfcgan_tpu_torch.parallel.tensor import full_tensors
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.recipes.tfcgan import StepDraws
    from tfcgan_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from tfcgan_tpu_torch.train.trainer import Trainer

    mesh = _mesh(tensor) if world > 1 else None
    recipe = build_recipe(cfg, "cpu")
    draw_fn = None
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
            if rank == 0:
                torch.save(grads, f"{tmp}/g_grads_{world}.pt")
        if state.step in saves:
            save_checkpoint(f"{tmp}/ckpt_{world}", state, mesh)
    return {"metrics": metrics, "sums": sums, "shapes": (before, shapes()),
            "allreduces": trainer.stats.grad_allreduces, "bytes": trainer.stats.flat_bytes}


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
