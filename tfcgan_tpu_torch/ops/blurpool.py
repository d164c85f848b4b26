"""Anti-aliased blur-pool (Zhang 2019), NHWC, port of ``tfcgan_tpu.ops.blurpool``.

``antialiased_cnns.BlurPool(filt_size=4)``: ReflectionPad2d((1, 2, 1, 2)),
then a depthwise [1,3,3,1]⊗[1,3,3,1]/64 filter at stride 1 or 2.

``blur_pool`` sends a CUDA tensor to the hand-written kernel
(``ops/kernels/blurpool.py``) and a CPU tensor to ``blur_pool_padded``, the
plain PyTorch version that the tests and ``chip_smoke.py`` hold the kernel to.
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


def blur_pool(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Blur + subsample of an NHWC tensor: the kernel on CUDA, the plain form
    on the CPU. The kernel has no backward yet, so a CUDA input that needs a
    gradient raises."""
    if x.device.type == "cpu":
        return blur_pool_padded(x, stride)
    if x.requires_grad:
        raise NotImplementedError(
            "blur_pool has no CUDA backward yet: it comes with the training slice "
            "(run the forward under torch.inference_mode() or torch.no_grad())")
    return _kernel.blur_pool_fwd(x, stride)
