"""The data, spatial and tensor axes over ``torch.distributed``, port of
``tfcgan_tpu.parallel.mesh``.

The JAX package shards the batch over a device mesh and lets XLA insert the
gradient ``psum``; here a process drives one card. ``Mesh`` is a small
record: the axis names and shape, this rank, the world size, the world's
process group, this rank's device, and its coordinates on the axes. Without
a spatial or tensor axis the world is the data axis. With
``make_mesh(spatial=s, tensor=t)`` the world of ``d * s * t`` ranks is a
(data, spatial, tensor) grid, ordered as JAX reshapes its devices, tensor
innermost: ``rank = (data_idx * s + spatial_idx) * t + tensor_idx``. The
ranks that share (data, spatial) form a tensor group (``parallel.tensor``:
every parameter that the JAX rule shards is held as a slice on each of them,
and its layer computes only its out-channels); those that share (data,
tensor) a spatial group (``parallel.spatial``: each holds a shard of every
image's rows, and the spatially aware layers exchange halo rows); those that
share (spatial, tensor) a data group. Parameters are broadcast from rank 0
(``replicate``/``place_state``, which then keeps each rank's slices on a
tensor mesh), a batch is cut into equal contiguous shares by the data
coordinate (``shard_batch``: the spatial and tensor ranks of a share see the
same samples and draws) and, on a spatial mesh, each image's rows by the
spatial coordinate, and the trainer reduces each phase's gradients over the
ranks that hold the same parameters (``all_reduce_mean_``).

Each data share computes its loss over its samples. For a term that is a
mean over samples, the mean of the shares' losses is the global batch's, and
so is the mean of their gradients. A term that couples samples differently
(a batch norm, a batch-wide min or max, a softmax over the batch) reads the
global batch through the collectives below, over the data group, each a
``torch.autograd.Function`` whose backward sums the shares' upstream
gradients: every rank computes the same global value, and the trainer's
mean over the data group then gives the global gradient once. The ops find
the mesh with ``active_mesh()``: the trainer runs each step inside
``loss_mesh(mesh)``, as the JAX trainer traces its step inside ``loss_mesh``.

``image_sharding`` returns as ``shard_batch``'s row cut (``SPATIAL_KEYS``).
The other ``NamedSharding`` helpers (``batch_sharding``,
``replicated_sharding``) have no meaning without XLA's partitioner and are
left out.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from tfcgan_tpu_torch.parallel.distributed import local_device
from tfcgan_tpu_torch.parallel.spatial import Rows, SpatialAxis
from tfcgan_tpu_torch.parallel.tensor import TensorAxis, _AllReduceSum, is_sharded, shard_params

# the batch arrays whose rows a spatial mesh cuts: the images, their uint8
# forms and the temperature map T_B (cut to match; the recipe gathers it
# with the images for the terms that read whole images)
SPATIAL_KEYS = ("A", "B", "T_B", "A_u8", "B_u8")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data mesh, or a (data[, spatial][, tensor]) one: ``axis_names``
    ("data",), ("data", "spatial"), ("data", "tensor") or ("data", "spatial",
    "tensor"), ``shape`` {"data": d[, "spatial": s][, "tensor": t]}, this
    global ``rank``, the ``world_size``, the world's process ``group`` (None
    for a world of one without ``torch.distributed``, where every collective
    is the identity) and this rank's ``device``; this rank's data coordinate
    ``data_rank`` of ``data_size`` and the ``data_group`` (None where the
    data axis has one coordinate), the ``tensor`` axis
    (``parallel.tensor.TensorAxis``) and the ``spatial`` axis
    (``parallel.spatial.SpatialAxis``), None where the mesh has none, and
    the ``replica_group``: the ranks that hold the same parameter slices
    (one tensor coordinate; the data group without a spatial axis, the world
    without a tensor axis). Without the data fields the data axis is the
    world."""

    axis_names: tuple[str, ...]
    shape: dict
    rank: int
    world_size: int
    group: object
    device: torch.device
    data_rank: int | None = None
    data_size: int | None = None
    data_group: object = None
    tensor: TensorAxis | None = None
    spatial: SpatialAxis | None = None
    replica_group: object = None

    def __post_init__(self):
        if self.data_size is None:  # a data mesh: the data axis is the world
            object.__setattr__(self, "data_rank", self.rank)
            object.__setattr__(self, "data_size", self.world_size)
            object.__setattr__(self, "data_group", self.group)
        if self.spatial is None and self.replica_group is None:
            object.__setattr__(self, "replica_group", self.data_group)

    @property
    def axis(self) -> str:
        return self.axis_names[0]

    @property
    def tensor_size(self) -> int:
        return 1 if self.tensor is None else self.tensor.size

    @property
    def spatial_size(self) -> int:
        return 1 if self.spatial is None else self.spatial.size

    @property
    def leads_tensor_group(self) -> bool:
        """Whether this rank is in rank 0's tensor group (data and spatial
        coordinates 0): the ranks that gather a sharded state with rank 0."""
        return self.rank < self.tensor_size

    def image_rows(self, h: int) -> Rows | None:
        """The row record of images of global height ``h`` (None without a
        spatial axis)."""
        return None if self.spatial is None else Rows(self.spatial, h)


def make_mesh(num_devices: int | None = None, axis: str = "data", spatial: int = 1,
              tensor: int = 1, device=None) -> Mesh:
    """The mesh over the initialised ``torch.distributed`` world (a world of
    one without it): a data mesh, or with ``spatial`` > 1 and/or ``tensor``
    > 1 a (data[, spatial][, tensor]) mesh of world / (``spatial`` x
    ``tensor``) data shares, tensor innermost, as the JAX ``make_mesh``
    orders its devices. The world must divide by ``spatial`` x ``tensor``
    (the JAX function asserts it), and ``num_devices`` must be the world
    size: the mesh never carries on with fewer ranks than it was asked for.
    ``device`` is this rank's device (default ``distributed.local_device``:
    ``cuda:$LOCAL_RANK`` under NCCL, the host under gloo). Every rank calls
    it: the groups are made collectively."""
    if dist.is_initialized():
        group, world, rank = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    else:
        group, world, rank = None, 1, 0
    if num_devices is not None and num_devices != world:
        raise ValueError(f"make_mesh({num_devices}) in a world of {world} process(es): start "
                         f"{num_devices} processes (torchrun --nproc_per_node {num_devices})")
    for name, n in (("spatial", spatial), ("tensor", tensor)):
        if n < 1 or world % n:
            raise ValueError(f"a world of {world} process(es) is not divisible by the "
                             f"'{name}' axis of {n}: start a multiple of {n} processes")
    if world % (spatial * tensor):
        raise ValueError(f"a world of {world} process(es) is not divisible by the 'spatial' x "
                         f"'tensor' axes of {spatial} x {tensor}")
    device = torch.device(device) if device is not None else local_device()
    if spatial == 1 and tensor == 1:
        return Mesh((axis,), {axis: world}, rank, world, group, device)
    data = world // (spatial * tensor)
    data_rank, rest = divmod(rank, spatial * tensor)
    spatial_rank, tensor_rank = divmod(rest, tensor)

    def ranks(d=None, s=None, t=None):
        return [(dd * spatial + ss) * tensor + tt for dd in ([d] if d is not None else range(data))
                for ss in ([s] if s is not None else range(spatial))
                for tt in ([t] if t is not None else range(tensor))]

    # every rank makes every group, in the same order
    def groups(n, members):
        return [dist.new_group(m) for m in members] if n > 1 else [None] * len(members)

    coords = [(d, s) for d in range(data) for s in range(spatial)]
    tensor_groups = groups(tensor, [ranks(d, s) for d, s in coords])
    spatial_groups = groups(spatial, [ranks(d, t=t) for d in range(data)
                                      for t in range(tensor)])
    data_groups = groups(data, [ranks(s=s, t=t) for s in range(spatial) for t in range(tensor)])
    if spatial == 1:
        replica = None  # the data group (Mesh.__post_init__)
    elif tensor == 1:
        replica = group
    else:
        replica = groups(data * spatial, [ranks(t=t) for t in range(tensor)])[tensor_rank]
    names = (axis, *(("spatial",) if spatial > 1 else ()), *(("tensor",) if tensor > 1 else ()))
    shape = {axis: data, "spatial": spatial, "tensor": tensor}
    return Mesh(names, {k: shape[k] for k in names}, rank, world, group, device, data_rank, data,
                data_groups[spatial_rank * tensor + tensor_rank],
                None if tensor == 1 else TensorAxis(tensor_groups[data_rank * spatial
                                                                  + spatial_rank],
                                                    tensor_rank, tensor),
                None if spatial == 1 else SpatialAxis(spatial_groups[data_rank * tensor
                                                                     + tensor_rank],
                                                      spatial_rank, spatial),
                replica)


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
    """This rank's contiguous share of ``n`` samples (equal shares only), by
    its data coordinate: the spatial and tensor ranks of a share get the same
    samples."""
    if n % mesh.data_size:
        raise ValueError(
            f"global batch size {n} is not divisible by the mesh's '{mesh.axis}' axis "
            f"({mesh.data_size} devices) — raise the batch size or shrink the mesh "
            f"(tfcgan_tpu_torch shards the batch dim over '{mesh.axis}')")
    share = n // mesh.data_size
    return slice(mesh.data_rank * share, (mesh.data_rank + 1) * share)


def local_part(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's share of a global-batch tensor (``x`` itself without a mesh)."""
    if mesh is None or mesh.data_size == 1:
        return x
    return x[local_share(x.shape[0], mesh)]


def shard_draws(draws, mesh: Mesh | None):
    """This rank's share of a step's draws, drawn for the global batch on
    every rank from generators kept equal and cut by the data coordinate
    (a dropout keep-mask that differed over a tensor group would make the
    gathered activations disagree): the per-sample fields that the
    draws' dataclass names in ``PER_SAMPLE`` (tensors, or dicts of tensors,
    with the batch first) are cut to this rank's samples; the shared fields
    (patch negatives, jitter factors, the replay buffers' coins) stay whole.
    On a spatial mesh the per-pixel fields named in ``PER_ROW`` (the dropout
    keep-masks, (N, H, W, C) at their maps' global heights) are also cut to
    this rank's rows of their maps."""
    if draws is None or mesh is None or (mesh.data_size == 1 and mesh.spatial is None):
        return draws

    def cut(v, rows):
        if isinstance(v, dict):
            return {k: cut(x, rows) for k, x in v.items()}
        if v is None:
            return None
        v = local_part(v, mesh)
        return mesh.image_rows(v.shape[1]).cut(v).contiguous() if rows else v

    per_row = getattr(type(draws), "PER_ROW", ()) if mesh.spatial is not None else ()
    return dataclasses.replace(draws, **{f: cut(getattr(draws, f), f in per_row)
                                         for f in type(draws).PER_SAMPLE})


def local_rows(batch: dict, mesh: Mesh | None) -> dict:
    """``batch`` with each image of ``SPATIAL_KEYS`` cut to this rank's rows
    on a spatial mesh (``batch`` itself off one): the JAX ``image_sharding``'s
    H split."""
    if mesh is None or mesh.spatial is None:
        return batch
    return {k: mesh.image_rows(v.shape[1]).cut(v) if k in SPATIAL_KEYS else v
            for k, v in batch.items()}


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous share of a global batch (numpy or tensors), on
    its device, each image cut to this rank's rows on a spatial mesh. The
    shares are equal: a mean of the ranks' means is then the global mean."""
    part = local_share(_leading(batch), mesh)
    batch = local_rows({k: torch.as_tensor(v[part]) for k, v in batch.items()}, mesh)
    return {k: v.contiguous().to(mesh.device) for k, v in batch.items()}


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
    one checkpoint every rank restores. On a tensor mesh each rank then keeps
    its slice of every parameter of G, D, LPIPS, the regional CNNs and the
    frozen modules that the JAX rule shards, and of its Adam moments
    (``parallel.tensor.shard_params``); u/v, ``extra``, the step and the
    generator stay replicated, as in the JAX ``place_state``. A state is
    placed once: the broadcast would hand rank 0's slices to every rank."""
    if mesh.group is None:
        return state
    modules = [m for m in (state.G, state.D, state.lpips, state.cnns, state.frozen)
               if m is not None]
    if any(is_sharded(m) for m in modules):
        raise ValueError("place_state: the state is already sharded over a tensor axis")
    replicate(modules, mesh)
    replicate(state.extra, mesh)
    meta = [state.step, state.generator.get_state()]
    nccl = dist.get_backend(mesh.group) == "nccl"
    dist.broadcast_object_list(meta, dist.get_global_rank(mesh.group, 0), group=mesh.group,
                               device=mesh.device if nccl else None)
    state.step = meta[0]
    state.generator.set_state(meta[1])
    if mesh.tensor is not None:
        shard_params(modules, mesh.tensor, (state.opt_g, state.opt_d))
    return state


# --------------------------------------------------------------- collectives
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
    """The sum of ``x`` over the data shares; backward: the all-reduce sum
    of the upstream gradient. The identity without a data group."""
    if mesh is None or mesh.data_group is None:
        return x
    return _AllReduceSum.apply(x, mesh.data_group)


def all_gather_batch(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The data shares' ``x`` concatenated along dim 0 in data order (the
    global batch, once: not once a tensor rank); backward: this share's
    slice of the summed upstream gradient."""
    if mesh is None or mesh.data_group is None:
        return x
    return _AllGatherBatch.apply(x, mesh.data_group, mesh.data_rank, mesh.data_size)


def all_reduce_max(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The max over every element of ``x`` in every data share (0-dim)."""
    if mesh is None or mesh.data_group is None:
        return x.amax()
    return _AllReduceExtreme.apply(x, mesh.data_group, True)


def all_reduce_min(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The min over every element of ``x`` in every data share (0-dim)."""
    if mesh is None or mesh.data_group is None:
        return x.amin()
    return _AllReduceExtreme.apply(x, mesh.data_group, False)


def all_reduce_mean_(tensors: list[torch.Tensor], mesh: Mesh, over: str = "data") -> int:
    """Reduce ``tensors`` (of one dtype) in place through one coalesced flat
    buffer, one all-reduce: summed over the spatial group (each spatial rank
    holds its share: ``parallel.spatial``'s rule) and averaged over the data
    group, over the replica group (``over="data"``: a sharded parameter's
    slice, a metric) or the whole world (``"world"``: a replicated
    parameter, equal over a tensor group, which is averaged too); returns
    the buffer's bytes (0 without a group)."""
    group, size = ((mesh.replica_group, mesh.data_size) if over == "data"
                   else (mesh.group, mesh.data_size * mesh.tensor_size))
    if group is None or not tensors:
        return 0
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError(f"one flat buffer takes one dtype: {sorted({str(t.dtype) for t in tensors})}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return flat.numel() * flat.element_size()
