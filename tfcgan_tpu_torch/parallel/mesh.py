"""The data axis over ``torch.distributed``, port of ``tfcgan_tpu.parallel.mesh``.

The JAX package shards the batch over a device mesh and lets XLA insert the
gradient ``psum``; here a process drives one card and the world of processes
is the data axis. ``Mesh`` is a small record: the axis names and shape, this
rank, the world size, the process group and this rank's device. Parameters
are replicated (``replicate``/``place_state`` broadcast them from rank 0), a
batch is cut into equal contiguous shares (``shard_batch``), and the trainer
averages each phase's gradients over the group.

Each rank computes its loss over its share. For a term that is a mean over
samples, the mean of the ranks' losses is the global batch's, and so is the
mean of their gradients. A term that couples samples differently (a batch
norm, a batch-wide min or max, a softmax over the batch) reads the global
batch through the collectives below, each a ``torch.autograd.Function``
whose backward sums the ranks' upstream gradients: every rank computes the
same global value, and the trainer's mean over ranks then gives the global
gradient once. The ops find the mesh with ``active_mesh()``: the trainer
runs each step inside ``loss_mesh(mesh)``, as the JAX trainer traces its
step inside ``loss_mesh``.

Only the data axis is ported: ``make_mesh`` refuses the ``spatial`` and
``tensor`` axes (ROADMAP, Queue 1 item 7). The ``NamedSharding`` helpers
(``batch_sharding``, ``image_sharding``, ``replicated_sharding``) have no
meaning without XLA's partitioner and are left out.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from tfcgan_tpu_torch.parallel.distributed import local_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: ``axis_names`` ("data",), ``shape`` {"data": world
    size}, this ``rank``, the process ``group`` (None for a world of one
    without ``torch.distributed``, where every collective is the identity)
    and this rank's ``device``."""

    axis_names: tuple[str, ...]
    shape: dict
    rank: int
    world_size: int
    group: object
    device: torch.device

    @property
    def axis(self) -> str:
        return self.axis_names[0]


def make_mesh(num_devices: int | None = None, axis: str = "data", spatial: int = 1,
              tensor: int = 1, device=None) -> Mesh:
    """The data mesh over the initialised ``torch.distributed`` world (a
    world of one without it). ``num_devices`` must be the world size: the
    mesh never carries on with fewer ranks than it was asked for.
    ``device`` is this rank's device (default ``distributed.local_device``:
    ``cuda:$LOCAL_RANK`` under NCCL, the host under gloo)."""
    for name, n in (("spatial", spatial), ("tensor", tensor)):
        if n > 1:
            raise NotImplementedError(
                f"the {name!r} mesh axis is not ported yet (ROADMAP.md, Queue 1 item 7: the "
                "spatial axis and then the tensor axis come after the data axis)")
    if dist.is_initialized():
        group, world, rank = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    else:
        group, world, rank = None, 1, 0
    if num_devices is not None and num_devices != world:
        raise ValueError(f"make_mesh({num_devices}) in a world of {world} process(es): start "
                         f"{num_devices} processes (torchrun --nproc_per_node {num_devices})")
    device = torch.device(device) if device is not None else local_device()
    return Mesh((axis,), {axis: world}, rank, world, group, device)


# the mesh that the collectives of the ops below see while a step runs
_ACTIVE_MESH: Mesh | None = None


@contextlib.contextmanager
def loss_mesh(mesh: Mesh | None):
    """Make ``mesh`` visible to the batch-coupled ops inside the block."""
    global _ACTIVE_MESH
    prev, _ACTIVE_MESH = _ACTIVE_MESH, mesh
    try:
        yield
    finally:
        _ACTIVE_MESH = prev


def active_mesh() -> Mesh | None:
    """The mesh of the running step, or None outside a data-parallel step."""
    return _ACTIVE_MESH


def _leading(batch: dict) -> int:
    sizes = {int(np.shape(v)[0]) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch arrays disagree on the batch size: {sorted(sizes)}")
    return sizes.pop()


def local_share(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous share of ``n`` samples (equal shares only)."""
    if n % mesh.world_size:
        raise ValueError(
            f"global batch size {n} is not divisible by the mesh's '{mesh.axis}' axis "
            f"({mesh.world_size} devices) — raise the batch size or shrink the mesh "
            f"(tfcgan_tpu_torch shards the batch dim over '{mesh.axis}')")
    share = n // mesh.world_size
    return slice(mesh.rank * share, (mesh.rank + 1) * share)


def local_part(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's share of a global-batch tensor (``x`` itself without a mesh)."""
    if mesh is None or mesh.world_size == 1:
        return x
    return x[local_share(x.shape[0], mesh)]


def shard_draws(draws, mesh: Mesh | None):
    """This rank's share of a step's draws, drawn for the global batch on
    every rank from generators kept equal: the per-sample fields that the
    draws' dataclass names in ``PER_SAMPLE`` (tensors, or dicts of tensors,
    with the batch first) are cut to this rank's samples; the shared fields
    (patch negatives, jitter factors, the replay buffers' coins) stay whole."""
    if draws is None or mesh is None or mesh.world_size == 1:
        return draws

    def cut(v):
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        return None if v is None else local_part(v, mesh)

    return dataclasses.replace(draws, **{f: cut(getattr(draws, f))
                                         for f in type(draws).PER_SAMPLE})


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous share of a global batch (numpy or tensors), on
    its device. The shares are equal: a mean of the ranks' means is then the
    global mean."""
    part = local_share(_leading(batch), mesh)
    return {k: torch.as_tensor(v[part]).to(mesh.device) for k, v in batch.items()}


def _tensors(obj) -> list[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.state_dict(keep_vars=True).values())
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def replicate(obj, mesh: Mesh):
    """Broadcast every tensor of ``obj`` (a tensor, a module's parameters and
    buffers, or dicts and lists of them) from rank 0, in place; returns ``obj``."""
    if mesh.group is None:
        return obj
    with torch.no_grad():
        for t in _tensors(obj):
            data = t.data if isinstance(t, torch.nn.Parameter) else t
            dist.broadcast(data, dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return obj


def place_state(state, mesh: Mesh):
    """Replicate a ``TrainState`` from rank 0: the modules' parameters and
    buffers (spectral u/v included), the recipe-owned ``extra``, the step
    count and the draw generator's state. The Adams start empty, or from the
    one checkpoint every rank restores."""
    if mesh.group is None:
        return state
    modules = [m for m in (state.G, state.D, state.lpips, state.cnns, state.frozen)
               if m is not None]
    replicate(modules, mesh)
    replicate(state.extra, mesh)
    meta = [state.step, state.generator.get_state()]
    nccl = dist.get_backend(mesh.group) == "nccl"
    dist.broadcast_object_list(meta, dist.get_global_rank(mesh.group, 0), group=mesh.group,
                               device=mesh.device if nccl else None)
    state.step = meta[0]
    state.generator.set_state(meta[1])
    return state


# --------------------------------------------------------------- collectives
class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, world):
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None, None


class _AllReduceExtreme(torch.autograd.Function):
    """The global max (or min) over every element on every rank; the
    gradient, the ranks' summed upstream, is split over the elements that
    hold the extreme on all ranks, as a max over the whole batch splits it
    over its ties."""

    @staticmethod
    def forward(ctx, x, group, largest):
        local = x.detach().amax() if largest else x.detach().amin()
        out = local.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if largest else dist.ReduceOp.MIN,
                        group=group)
        hit = x.detach() == out
        ties = hit.sum()
        dist.all_reduce(ties, group=group)
        ctx.group = group
        ctx.save_for_backward(hit, ties)
        return out

    @staticmethod
    def backward(ctx, g):
        hit, ties = ctx.saved_tensors
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return hit.to(g.dtype) * (g / ties.to(g.dtype)), None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``x`` over the ranks; backward: the all-reduce sum of the
    upstream gradient. The identity without a group."""
    if mesh is None or mesh.group is None:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def all_gather_batch(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order (the global
    batch); backward: this rank's slice of the summed upstream gradient."""
    if mesh is None or mesh.group is None:
        return x
    return _AllGatherBatch.apply(x, mesh.group, mesh.rank, mesh.world_size)


def all_reduce_max(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The max over every element of ``x`` on every rank (0-dim)."""
    if mesh is None or mesh.group is None:
        return x.amax()
    return _AllReduceExtreme.apply(x, mesh.group, True)


def all_reduce_min(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The min over every element of ``x`` on every rank (0-dim)."""
    if mesh is None or mesh.group is None:
        return x.amin()
    return _AllReduceExtreme.apply(x, mesh.group, False)


def all_reduce_mean_(tensors: list[torch.Tensor], mesh: Mesh) -> int:
    """Average ``tensors`` (of one dtype) over the ranks in place through one
    coalesced flat buffer, one all-reduce; returns the buffer's bytes (0
    without a group)."""
    if mesh.group is None or not tensors:
        return 0
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError(f"one flat buffer takes one dtype: {sorted({str(t.dtype) for t in tensors})}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.world_size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return flat.numel() * flat.element_size()
