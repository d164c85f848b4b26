"""The ``tensor`` mesh axis: column-parallel layers over a tensor process group.

The JAX package shards every parameter leaf of two or more dimensions on its
last dimension (conv HWIO out-channels, dense out-features) over the mesh's
``tensor`` axis where that dimension divides evenly
(``tfcgan_tpu.parallel.mesh.param_sharding``), and GSPMD inserts the
activation collectives. Here the ranks of one data share form a tensor
process group, and the layers carry the collectives themselves:

- ``param_sharding_dim`` is that rule on the port's modules: the torch dim
  that is the flax leaf's last (0 for a conv's or a Dense's weight, 1 for a
  transposed conv's, the last for a raw parameter such as the ViT's
  ``pos_embed``), or None to replicate. A module names its candidate
  parameters in ``tensor_dims``; a leaf that is 1-D in flax (biases, norm
  scales) is never named and stays replicated.
- ``shard_params`` keeps each rank's contiguous slice of every sharded
  parameter, in place on ``.data`` (the Adams keep their ``Parameter``
  objects), slices Adam's moments alike, and marks the parameter
  (``tensor_dim``, ``tensor_axis``) and its module (``tensor_axis``).
- A sharded layer computes only its out-channels (``column_parallel``): its
  input passes ``_ReduceGrad`` (identity forward; backward, the all-reduce
  sum of the input gradient, each rank's being a partial sum over its
  out-channels), its output ``_GatherDim`` (all-gather on the channel dim;
  backward, this rank's slice of the upstream gradient, which is the same on
  every rank: whatever follows the gather runs replicated). A replicated bias
  is added after the gather, so that its gradient is the same on every rank.
- ``full_param`` gathers a raw parameter before its use (differentiably);
  ``full_state_dict`` / ``full_optimizer_state_dict`` gather a module's or an
  Adam's state (not differentiably) for a checkpoint, a histogram or a serve
  copy, in the layout of an unsharded run.

Every rank of a tensor group runs the same layers in the same order, so the
collectives of the forward and of the backward pair up.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist
import torch.nn as nn


@dataclasses.dataclass(frozen=True)
class TensorAxis:
    """This rank's tensor process group, its rank in it and the group's size."""

    group: object
    rank: int
    size: int


def tensor_dim(p: torch.Tensor) -> int | None:
    """The dim over which the parameter ``p`` is sharded, or None."""
    return getattr(p, "tensor_dim", None)


def param_sharding_dim(module: nn.Module, name: str, param: torch.Tensor, t: int) -> int | None:
    """The torch dim of ``module``'s parameter ``name`` that the JAX rule
    shards over a tensor axis of ``t`` ranks, or None to replicate it. The
    dim is the flax leaf's last; the leaf is sharded where that dim's size
    (over ``module.tensor_blocks`` blocks: the heads of an attention's q/k/v,
    whose flax leaf ends in the head dim) divides by ``t`` and is at least ``t``."""
    dims = getattr(module, "tensor_dims", None)
    if dims is None and isinstance(module, nn.Conv2d):  # the ViT's patch embedding
        dims = {"weight": 0}
    dim = (dims or {}).get(name)
    if dim is None:
        return None
    size = param.shape[dim] // getattr(module, "tensor_blocks", 1)
    return dim if size >= t and size % t == 0 else None


def _slice(x: torch.Tensor, dim: int, axis: TensorAxis) -> torch.Tensor:
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n).clone(memory_format=torch.contiguous_format)


@torch.no_grad()
def shard_params(modules, axis: TensorAxis, optimizers=()) -> None:
    """Keep this rank's slice of every parameter of ``modules`` that
    ``param_sharding_dim`` shards, and of its Adam moments in ``optimizers``
    (those that exist with the parameter's full shape)."""
    seen = set()
    for root in modules:
        for module in root.modules():
            for name, p in module.named_parameters(recurse=False):
                dim = param_sharding_dim(module, name, p, axis.size)
                if dim is None or id(p) in seen:
                    continue
                seen.add(id(p))
                full = p.shape
                p.data = _slice(p.data, dim, axis)
                p.tensor_dim, p.tensor_axis = dim, axis
                module.tensor_axis = axis
                for opt in optimizers:
                    state = opt.state.get(p) if opt is not None else None
                    for k in ("exp_avg", "exp_avg_sq"):
                        if state and k in state and state[k].shape == full:
                            state[k] = _slice(state[k], dim, axis)


def is_sharded(module: nn.Module | None) -> bool:
    return module is not None and any(tensor_dim(p) is not None for p in module.parameters())


# --------------------------------------------------------------- collectives
def gather_dim(x: torch.Tensor, dim: int, axis: TensorAxis) -> torch.Tensor:
    """The tensor group's ``x`` concatenated along ``dim`` in rank order (no autograd)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim)


class _GatherDim(torch.autograd.Function):
    """All-gather on ``dim``; backward: this rank's slice of the upstream
    gradient (replicated over the group, so no sum)."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, x.shape[dim]
        return gather_dim(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


class _ReduceGrad(torch.autograd.Function):
    """Identity; backward: the all-reduce sum of the upstream gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group``; backward: the sum of the upstream gradients
    (the data axis's ``all_reduce_sum`` too)."""

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


def tensor_sum(x: torch.Tensor, axis: TensorAxis) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (a spectral norm's u . W v)."""
    return _AllReduceSum.apply(x, axis.group)


def column_parallel(module: nn.Module, x: torch.Tensor, compute) -> torch.Tensor:
    """``compute(x, weight, bias)`` with this rank's out-channel slice of
    ``module.weight`` (and of its bias where that is sharded, else None),
    channels last, gathered over the tensor group; a replicated bias added
    after the gather."""
    axis = module.tensor_axis
    bias = getattr(module, "bias", None)
    local_bias = bias if bias is not None and tensor_dim(bias) is not None else None
    if x.requires_grad:
        x = _ReduceGrad.apply(x, axis)
    y = _GatherDim.apply(compute(x, module.weight, local_bias), -1, axis)
    if bias is not None and local_bias is None:
        y = y + bias.to(y.dtype)
    return y


def full_param(module: nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name``, gathered (differentiably) where it is sharded."""
    p = getattr(module, name)
    dim = tensor_dim(p)
    return p if dim is None else _GatherDim.apply(p, dim, p.tensor_axis)


@torch.no_grad()
def full_tensors(module: nn.Module, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``tensors`` keyed by ``module``'s parameter names (the parameters
    themselves, or their gradients), each sharded one gathered."""
    out = dict(tensors)
    for name, p in module.named_parameters():
        dim = tensor_dim(p)
        if dim is not None and name in out:
            out[name] = gather_dim(out[name].detach(), dim, p.tensor_axis)
    return out


def full_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded parameter gathered: the
    state dict of the unsharded module. A collective over each tensor group
    that holds a shard; the plain state dict where nothing is sharded."""
    sd = module.state_dict()
    if not is_sharded(module):
        return sd
    return full_tensors(module, sd)


def full_optimizer_state_dict(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` with the moments of every sharded parameter
    gathered (new dicts: the optimizer's own state is not touched)."""
    sd = opt.state_dict()
    params = [p for group in opt.param_groups for p in group["params"]]
    for i, p in enumerate(params):
        dim = tensor_dim(p)
        if dim is None or i not in sd["state"]:
            continue
        st = dict(sd["state"][i])
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                st[k] = gather_dim(st[k], dim, p.tensor_axis)
        sd["state"][i] = st
    return sd


@torch.no_grad()
def gathered_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` with full, replicated weights and no tensor
    group (``module`` itself where nothing is sharded)."""
    if not is_sharded(module):
        return module
    full = full_state_dict(module)
    axes = {id(m.tensor_axis): m.tensor_axis for m in module.modules()
            if "tensor_axis" in m.__dict__}
    out = copy.deepcopy(module, axes)  # a process group is not copied
    for m in out.modules():
        m.__dict__.pop("tensor_axis", None)
    for name, p in out.named_parameters():  # a copied Parameter has no tensor_dim
        p.data = full[name].clone()
    return out
