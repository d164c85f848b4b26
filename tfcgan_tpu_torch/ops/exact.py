"""Float32 products that stay float32 on the card, forward and backward.

cuDNN runs float32 convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32``
is off, and a user may turn TF32 on for matmuls. The few float32 products
whose result the JAX package computes at ``Precision.HIGHEST`` (the saliency
filters, the favtgan temperature-map product) go through these autograd
functions, which run their forward and their backward with TF32 off whatever
the global flags say.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


class _Bmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with full_fp32():
            return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with full_fp32():
            ga = torch.bmm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] else None
            gb = torch.bmm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def bmm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, I, J) @ (N, J, K) -> (N, I, K) in float32 without TF32."""
    return _Bmm.apply(a.float(), b.float())


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(k)
        with full_fp32():
            return F.conv2d(x, k)

    @staticmethod
    def backward(ctx, g):
        (k,) = ctx.saved_tensors
        with full_fp32():
            return F.conv_transpose2d(g, k), None


def conv2d_fp32(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'Valid' float32 cross-correlation of (N, 1, H, W) ``x`` with the 2-D
    ``kernel`` (no gradient to the kernel), without TF32."""
    return _Conv.apply(x.float(), kernel.float()[None, None])
