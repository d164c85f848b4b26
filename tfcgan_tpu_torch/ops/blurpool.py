"""Anti-aliased blur-pool (Zhang 2019), NHWC, port of ``tfcgan_tpu.ops.blurpool``.

``antialiased_cnns.BlurPool(filt_size=4)``: ReflectionPad2d((1, 2, 1, 2)),
then a depthwise [1,3,3,1]⊗[1,3,3,1]/64 filter at stride 1 or 2.

``blur_pool`` sends a CUDA tensor through ``BlurPool``, an autograd function
whose forward and backward are the hand-written kernels
(``ops/kernels/blurpool.py``), and a CPU tensor to ``blur_pool_padded``, the
plain PyTorch version that the tests and ``chip_smoke.py`` hold the kernels
to (autograd of it is the plain backward).

Both take a row window (the row-edge form; by default the whole map). On a
spatial mesh (``parallel.spatial``) ``blur_pool(x, stride, rows)`` runs on
row shards: each rank fetches the rows its outputs read from its neighbours
and computes its output rows in the window those rows make, which reflects
only at the map's own top and bottom edges.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tfcgan_tpu_torch.ops.kernels import blurpool as _kernel
from tfcgan_tpu_torch.ops.kernels.blurpool import reflect_index
from tfcgan_tpu_torch.parallel.spatial import Rows, row_op

_TAPS = (1.0, 3.0, 3.0, 1.0)


@functools.cache
def _window_index(h_glob: int, row0: int, o_base: int, ho: int, stride: int) -> tuple[int, ...]:
    return tuple(reflect_index(j, h_glob) - row0
                 for j in range(stride * o_base - 1, stride * (o_base + ho - 1) + 3))


def blur_pool_padded(x: torch.Tensor, stride: int = 2, window=None, ho: int | None = None
                     ) -> torch.Tensor:
    """The plain form: materialized reflect pad + one depthwise conv.
    x: (N, H, W, C); returns (N, Ho, Wo, C) NHWC-contiguous. With
    ``window=(h_glob, row0, o_base)`` the row-edge form: x is rows [row0,
    row0 + H) of a map of ``h_glob`` rows, and the result that map's output
    rows [o_base, o_base + ho), reflected only at the map's edges; by default
    the whole map, ``(H, 0, 0)``."""
    n, h, w, c = x.shape
    if window is None:
        window, ho = (h, 0, 0), _kernel.out_len(h, stride)
    rows = torch.tensor(_window_index(*window, ho, stride), device=x.device)
    cols = torch.tensor(_window_index(w, 0, 0, _kernel.out_len(w, stride), stride),
                        device=x.device)
    xp = x.index_select(1, rows).index_select(2, cols)  # (N, <= H+3, <= W+3, C)
    taps = torch.tensor(_TAPS, device=x.device)
    weight = (torch.outer(taps, taps) / 64.0).to(x.dtype)  # [1,3,3,1]⊗[1,3,3,1]/64
    weight = weight.expand(c, 1, 4, 4).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xp.permute(0, 3, 1, 2), weight, stride=stride, groups=c)
    return y.permute(0, 2, 3, 1).contiguous()


class BlurPool(torch.autograd.Function):
    """The kernel pair as one differentiable op, on a row window of the map
    as ``blur_pool_padded`` takes it. The op is linear, so the backward needs
    only the input's height and width, the stride and the window."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, stride: int, window, ho) -> torch.Tensor:
        ctx.hw_stride, ctx.window = (x.shape[1], x.shape[2], stride), window
        return _kernel.blur_pool_fwd(x, stride, window, ho)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        # the gradient of a sliced or padded consumer (the discriminator's
        # last conv) can arrive strided; the kernel reads NHWC-contiguous
        return _kernel.blur_pool_bwd(dy.contiguous(), *ctx.hw_stride, ctx.window), None, None, None


def _blur(x: torch.Tensor, stride: int, window=None, ho: int | None = None) -> torch.Tensor:
    if x.device.type == "cpu":
        return blur_pool_padded(x, stride, window, ho)
    return BlurPool.apply(x, stride, window, ho)


def blur_pool(x: torch.Tensor, stride: int = 2, rows: Rows | None = None) -> torch.Tensor:
    """Blur + subsample of an NHWC tensor: the kernels on CUDA (forward and,
    where autograd needs it, backward), the plain form on the CPU. With
    ``rows``, x is this rank's row shard of a map of ``rows.h`` rows, and the
    result its shard of the output (``parallel.spatial.row_op``)."""
    if rows is None or rows.axis.size == 1:
        return _blur(x, stride)
    h = rows.h

    def compute(xw, a, b, o_lo, o_hi):
        return _blur(xw.contiguous(), stride, (h, a, o_lo), o_hi - o_lo)

    return row_op(x, rows, _kernel.out_len(h, stride),
                  lambda o_lo, o_hi: _kernel.window_rows(h, o_lo, o_hi - o_lo, stride),
                  compute, edge="clip")
