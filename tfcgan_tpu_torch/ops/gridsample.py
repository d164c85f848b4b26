"""Bilinear grid sampling on a dense (per-pixel) grid, port of
``tfcgan_tpu.ops.pallas_kernels.gridsample``: what NeMAR's deformable STN warps
its full-resolution images with.

``grid_sample_dense(inp, grid, "bilinear", padding_mode, align_corners)`` has
torch's ``F.grid_sample`` semantics on an NHWC image and a normalized
``(N, Hg, Wg, 2)`` grid of (x, y): float32 arithmetic, the result in ``inp``'s
dtype. A CUDA tensor goes through ``GridSampleDense``, the autograd function
around the two hand-written kernels (``ops/kernels/gridsample.py``): the
forward, and a backward that gives the image gradient and the grid gradient,
each only where autograd asks for it. A CPU tensor goes to the plain version,
``ops/warp.grid_sample`` in float32, whose autograd gradients are the plain
backward. ``F.grid_sample`` itself is not called.

The image gradient is summed with atomics, so two runs of the backward on a
card differ in its last bits; the grid gradient and the forward repeat
exactly.

On row shards (``rows``, the spatial mesh axis) a sample can fall on any
row of the image, so both forms take the image gathered once over the
spatial group (``parallel.spatial.gather_spatial``) and this rank's rows of
the grid, in the global normalised coordinates: the kernels take a grid of
any height, so this needs no other launch. The image gradient then comes
back whole on every rank, and the gather's backward sums it onto each
owner's rows.
"""

from __future__ import annotations

import torch

from tfcgan_tpu_torch.ops import warp
from tfcgan_tpu_torch.ops.kernels import gridsample as _kernel
from tfcgan_tpu_torch.parallel.spatial import Rows, gather_spatial


def grid_sample_dense_plain(inp: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                            padding_mode: str = "zeros", align_corners: bool = False,
                            rows: Rows | None = None) -> torch.Tensor:
    """The plain version on any device: ``ops/warp.grid_sample`` (bilinear) in
    float32, the result in ``inp``'s dtype. Differentiable in inp and grid.
    With ``rows``, ``inp`` is this rank's rows of images of ``rows.h`` rows,
    gathered here, and ``grid`` this rank's rows of the grid."""
    if mode != "bilinear":
        raise ValueError("grid_sample_dense implements bilinear only")
    inp = gather_spatial(inp, rows)
    out = warp.grid_sample(inp.float(), grid.float(), mode="bilinear",
                           padding_mode=padding_mode, align_corners=align_corners)
    return out.to(inp.dtype)


class GridSampleDense(torch.autograd.Function):
    """The two kernels as one differentiable op on CUDA tensors; the backward
    launches once and computes only the gradients autograd needs."""

    @staticmethod
    def forward(ctx, inp, grid, padding_mode: str, align_corners: bool):
        ctx.save_for_backward(inp, grid)
        ctx.args = (padding_mode, align_corners)
        return _kernel.gridsample_fwd(inp, grid, padding_mode, align_corners)

    @staticmethod
    def backward(ctx, g):
        inp, grid = ctx.saved_tensors
        need_inp, need_grid = ctx.needs_input_grad[:2]
        d_inp, d_grid = _kernel.gridsample_bwd(g.contiguous(), inp, grid, *ctx.args,
                                               need_inp=need_inp, need_grid=need_grid)
        if d_inp is not None:
            d_inp = d_inp.to(inp.dtype)
        return d_inp, d_grid, None, None


def grid_sample_dense(inp: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                      padding_mode: str = "zeros", align_corners: bool = False,
                      rows: Rows | None = None) -> torch.Tensor:
    """inp: (N, H, W, C) contiguous, float32 or bfloat16; grid: (N, Hg, Wg, 2)
    normalized (x, y) -> (N, Hg, Wg, C) in inp's dtype. The kernels on CUDA,
    the plain version on the CPU. With ``rows``, ``inp`` is this rank's rows
    of images of ``rows.h`` rows (gathered once here) and ``grid`` and the
    result this rank's rows of theirs."""
    if inp.device.type == "cpu":
        return grid_sample_dense_plain(inp, grid, mode, padding_mode, align_corners, rows)
    if mode != "bilinear":
        raise ValueError("grid_sample_dense implements bilinear only")
    return GridSampleDense.apply(gather_spatial(inp, rows), grid.float().contiguous(),
                                 padding_mode, align_corners)
