"""Instance norm with ``nn.InstanceNorm2d`` defaults (affine=False, eps=1e-5),
NHWC, port of ``tfcgan_tpu.ops.norm``, and flax's ``GroupNorm`` arithmetic for
the diffusion U-Net.

The package's own function rather than ``F.instance_norm``: the generator
normalizes a 1×1 map at ``down6`` for a 64² input, which must give zeros as
it does in the JAX package, and which torch's InstanceNorm rejects.
"""

from __future__ import annotations

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (N, H, W, C). Normalizes each (n, c) plane over (H, W).

    float32 uses the centred two-pass form. Lower precisions take fp32
    statistics in the E[x²]−μ² form and scale in their own dtype, as the JAX
    function does."""
    if x.dtype == torch.float32:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps)
    m = x.mean(dim=(1, 2), keepdim=True, dtype=torch.float32)
    m2 = x.float().square().mean(dim=(1, 2), keepdim=True)
    var = (m2 - m.square()).clamp_min(0.0)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return (x - m.to(x.dtype)) * scale


def group_norm(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """x: (N, H, W, C) -> float32 (N, H, W, C), each sample's groups of
    C / groups channels normalized over (H, W, group) and scaled per channel.

    Flax's arithmetic in every dtype: float32 statistics in the fast-variance
    form max(0, E[x²] − E[x]²), then (x − μ) · (rsqrt(var + eps) · weight) +
    bias. The caller casts the result to its compute dtype."""
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight.float().view(1, 1, groups, -1)
    return ((xf - mean) * mul + bias.float().view(1, 1, groups, -1)).reshape(n, h, w, c)
