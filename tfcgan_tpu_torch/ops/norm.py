"""Instance norm with ``nn.InstanceNorm2d`` defaults (affine=False, eps=1e-5),
NHWC, port of ``tfcgan_tpu.ops.norm``.

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
