"""Anti-aliased blur-pool (Zhang 2019), NHWC, port of ``tfcgan_tpu.ops.blurpool``.

``antialiased_cnns.BlurPool(filt_size=4)``: ReflectionPad2d((1, 2, 1, 2)),
then a depthwise [1,3,3,1]⊗[1,3,3,1]/64 filter at stride 1 or 2.

``blur_pool`` sends a CUDA tensor through ``BlurPool``, an autograd function
whose forward and backward are the hand-written kernels
(``ops/kernels/blurpool.py``), and a CPU tensor to ``blur_pool_padded``, the
plain PyTorch version that the tests and ``chip_smoke.py`` hold the kernels
to (autograd of it is the plain backward).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tfcgan_tpu_torch.ops.kernels import blurpool as _kernel

_TAPS = (1.0, 3.0, 3.0, 1.0)


def reflect_index(j: int, n: int) -> int:
    """Reflection without repeating the edge sample, for every n >= 1 and any
    j (``_reflect`` of the TPU kernel's module, also used by csrc/blurpool.cu).
    Unlike ``F.pad(mode="reflect")`` it takes pads as long as the axis or
    longer, which the generator reaches at 64² (n = 1 at down6, 2 at up1)."""
    if n == 1:
        return 0
    j = j % (2 * (n - 1))
    return j if j < n else 2 * (n - 1) - j


@functools.cache
def _padded_index(n: int) -> tuple[int, ...]:
    return tuple(reflect_index(p - 1, n) for p in range(n + 3))


def blur_pool_padded(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """The plain form: materialized reflect pad + one depthwise conv.
    x: (N, H, W, C); returns (N, Ho, Wo, C) NHWC-contiguous."""
    n, h, w, c = x.shape
    rows = torch.tensor(_padded_index(h), device=x.device)
    cols = torch.tensor(_padded_index(w), device=x.device)
    xp = x.index_select(1, rows).index_select(2, cols)  # (N, H+3, W+3, C)
    taps = torch.tensor(_TAPS, device=x.device)
    weight = (torch.outer(taps, taps) / 64.0).to(x.dtype)  # [1,3,3,1]⊗[1,3,3,1]/64
    weight = weight.expand(c, 1, 4, 4).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xp.permute(0, 3, 1, 2), weight, stride=stride, groups=c)
    return y.permute(0, 2, 3, 1).contiguous()


class BlurPool(torch.autograd.Function):
    """The kernel pair as one differentiable op. The op is linear, so the
    backward needs only the input's height, width and the stride."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, stride: int) -> torch.Tensor:
        ctx.hw_stride = (x.shape[1], x.shape[2], stride)
        return _kernel.blur_pool_fwd(x, stride)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        # the gradient of a sliced or padded consumer (the discriminator's
        # last conv) can arrive strided; the kernel reads NHWC-contiguous
        return _kernel.blur_pool_bwd(dy.contiguous(), *ctx.hw_stride), None


def blur_pool(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Blur + subsample of an NHWC tensor: the kernels on CUDA (forward and,
    where autograd needs it, backward), the plain form on the CPU."""
    if x.device.type == "cpu":
        return blur_pool_padded(x, stride)
    return BlurPool.apply(x, stride)
