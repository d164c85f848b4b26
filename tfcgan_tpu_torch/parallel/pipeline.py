"""Pipeline parallelism (GPipe) over the ranks of a ``pipe`` group, port of
``tfcgan_tpu.parallel.pipeline``.

The pipelined region is a homogeneous stack of stages (``stage_fn(params,
x) -> y`` with ``y.shape == x.shape``); in this model zoo, the ResNet trunk of
``models/resnet_gen.py`` (CycleGAN's and NeMAR's residual blocks). Stage s
runs on rank s of the group; microbatches stream through point-to-point
``send``/``recv`` in place of the JAX ``ppermute``: rank s takes microbatch m
from rank s - 1 (rank 0 from the input), applies its stage and sends the
result on, so that with S stages and M microbatches the schedule is GPipe's
fill and drain, bubble (S - 1) / (M + S - 1). Ranks idle in the bubble
instead of computing on zeros as the JAX scan does.

JAX gets the backward pipeline from AD (``ppermute``'s transpose); here it is
written out in ``_GPipe.backward``: the last stage takes each microbatch's
output gradient, every stage back-propagates through the graph it kept and
sends the input gradient to the stage before it, in reverse order.

Replicated in, replicated out: every rank passes the whole batch and the
whole stack of stage parameters, and gets the whole output, which the last
stage broadcasts (the JAX ``psum`` over masked emits). Its backward takes
the mean of the ranks' upstream gradients (each rank holds a replica of the
output, as the data axis averages replicas); the input gradient is broadcast
from stage 0, and the gradient of the stacked parameters is summed over the
stages, each of which filled its own slice. So the gradients equal the
serial trunk's on every rank. Each rank still holds the whole stack (the
JAX mesh holds 1/S of it per device).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tfcgan_tpu_torch.parallel.mesh import Mesh


def stack_stages(per_stage_params: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """S per-stage parameter dicts (identical names and shapes; a module's
    dotted names, as ``named_parameters`` gives them) -> one dict of leaves
    with a leading stage dim S."""
    return {k: torch.stack([p[k] for p in per_stage_params]) for k in per_stage_params[0]}


def make_pipe_mesh(num_stages: int, device=None) -> Mesh:
    """A ``pipe`` mesh over the first ``num_stages`` ranks of the world (a
    stage of one without ``torch.distributed``). Every rank of the world
    calls it; a rank outside the pipe gets a mesh it must not run."""
    from tfcgan_tpu_torch.parallel.distributed import local_device

    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if world < num_stages:
            raise ValueError(f"make_pipe_mesh({num_stages}) needs {num_stages} ranks, the "
                             f"world has {world}")
        group = (dist.group.WORLD if num_stages == world
                 else dist.new_group(list(range(num_stages))))
    elif num_stages == 1:
        group, rank = None, 0
    else:
        raise ValueError(f"make_pipe_mesh({num_stages}) needs {num_stages} ranks: "
                         "torch.distributed is not initialised")
    device = torch.device(device) if device is not None else local_device()
    return Mesh(("pipe",), {"pipe": num_stages}, rank, num_stages, group, device)


def _global(group, i: int) -> int:
    return dist.get_global_rank(group, i)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, names, mesh, microbatches, x, *leaves):
        stages, s, group = mesh.world_size, mesh.rank, mesh.group
        params = {n: leaf[s].detach().requires_grad_(leaf.requires_grad)
                  for n, leaf in zip(names, leaves)}
        chunks = x.detach().chunk(microbatches)
        inputs, outputs = [], []
        for m in range(microbatches):
            if s == 0:
                xin = chunks[m]
            else:
                xin = torch.empty_like(chunks[m])
                dist.recv(xin, _global(group, s - 1), group=group)
            xin = xin.detach().requires_grad_(x.requires_grad or s > 0)
            with torch.enable_grad():
                y = stage_fn(params, xin)
            inputs.append(xin)
            outputs.append(y)
            if s < stages - 1:
                dist.send(y.detach().contiguous(), _global(group, s + 1), group=group)
        out = (torch.cat([y.detach() for y in outputs]) if s == stages - 1
               else torch.empty_like(x))
        if group is not None:
            dist.broadcast(out, _global(group, stages - 1), group=group)
        ctx.state = (mesh, params, names, inputs, outputs, [leaf.shape for leaf in leaves],
                     [leaf.requires_grad for leaf in leaves], x.requires_grad)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, params, names, inputs, outputs, shapes, need, x_grad = ctx.state
        stages, s, group = mesh.world_size, mesh.rank, mesh.group
        g = g.contiguous()
        if group is not None:
            g = g.clone()
            dist.all_reduce(g, group=group)
            g /= stages
        dys = g.chunk(len(outputs))
        grads = {n: None for n in names}
        dxs = [None] * len(outputs)
        for m in reversed(range(len(outputs))):
            if s == stages - 1:
                dy = dys[m]
            else:
                dy = torch.empty_like(outputs[m])
                dist.recv(dy, _global(group, s + 1), group=group)
            wrt = [inputs[m]] if inputs[m].requires_grad else []
            wrt += [params[n] for n in names if params[n].requires_grad]
            got = torch.autograd.grad(outputs[m], wrt, dy, allow_unused=True)
            if inputs[m].requires_grad:
                dxs[m], got = got[0], got[1:]
            for n, d in zip([n for n in names if params[n].requires_grad], got):
                if d is not None:
                    grads[n] = d if grads[n] is None else grads[n] + d
            if s > 0:
                dist.send(dxs[m].contiguous(), _global(group, s - 1), group=group)
        gx = None
        if x_grad:
            gx = torch.cat(dxs) if s == 0 else torch.empty_like(g)
            if group is not None:
                dist.broadcast(gx, _global(group, 0), group=group)
        leaf_grads = []
        for n, shape, req in zip(names, shapes, need):
            if not req:
                leaf_grads.append(None)
                continue
            full = torch.zeros(shape, dtype=params[n].dtype, device=params[n].device)
            if grads[n] is not None:
                full[s] = grads[n]
            if group is not None:
                dist.all_reduce(full, group=group)
            leaf_grads.append(full)
        return (None, None, None, None, gx, *leaf_grads)


def pipeline_apply(stage_fn, stacked_params: dict, x: torch.Tensor, *, mesh: Mesh,
                   microbatches: int, axis: str = "pipe") -> torch.Tensor:
    """``stage_{S-1}(...stage_1(stage_0(x)))`` pipelined over ``mesh``'s
    ``axis``. ``stage_fn(stage_params, x) -> y`` with ``y.shape ==
    x.shape``, ``stage_params`` one stage's slice of ``stacked_params`` (a
    flat dict of leaves with a leading stage dim S, from ``stack_stages``). ``x`` (N, ...)
    with N divisible by ``microbatches``; every op of a stage treats the
    samples apart (instance norm included), so microbatching gives the serial
    result."""
    stages = mesh.shape[axis]
    n = x.shape[0]
    assert n % microbatches == 0, (n, microbatches)
    for name, leaf in stacked_params.items():
        assert leaf.shape[0] == stages, (name, tuple(leaf.shape), stages)
    names = list(stacked_params)
    return _GPipe.apply(stage_fn, names, mesh, microbatches, x, *stacked_params.values())


def resnet_trunk_pipeline(block_apply, block_params: list[dict], x: torch.Tensor, *,
                          mesh: Mesh, microbatches: int) -> torch.Tensor:
    """The list of identical residual blocks pipelined over the ``pipe``
    axis: S contiguous stages of len(block_params) / S blocks each, a stage
    running its blocks in order. ``block_apply(params, x) -> y`` is one block
    (``torch.func.functional_call`` of a ``ResidualBlock``)."""
    stages = mesh.shape["pipe"]
    blocks = len(block_params)
    assert blocks % stages == 0, (blocks, stages)
    k = blocks // stages
    stacked = stack_stages([stack_stages(block_params[i * k:(i + 1) * k])
                            for i in range(stages)])  # leaves (S, k, ...)

    def stage_fn(stage_params, h):
        for j in range(k):
            h = block_apply({n: v[j] for n, v in stage_params.items()}, h)
        return h

    return pipeline_apply(stage_fn, stacked, x, mesh=mesh, microbatches=microbatches)
