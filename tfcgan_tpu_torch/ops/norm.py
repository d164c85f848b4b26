"""Instance norm with ``nn.InstanceNorm2d`` defaults (affine=False, eps=1e-5),
NHWC, port of ``tfcgan_tpu.ops.norm``, and flax's ``GroupNorm`` arithmetic for
the diffusion U-Net.

The package's own function rather than ``F.instance_norm``: the generator
normalizes a 1×1 map at ``down6`` for a 64² input, which must give zeros as
it does in the JAX package, and which torch's InstanceNorm rejects.

On row shards (``rows``, ``parallel.spatial``) the statistics are the
spatial group's sums over the whole (H, W) plane, in both forms.
"""

from __future__ import annotations

import torch

from tfcgan_tpu_torch.parallel.spatial import Rows, spatial_sum


def instance_norm(x: torch.Tensor, eps: float = 1e-5, rows: Rows | None = None) -> torch.Tensor:
    """x: (N, H, W, C). Normalizes each (n, c) plane over (H, W); with
    ``rows``, x is this rank's row shard of planes of ``rows.h`` rows.

    float32 (and float64, in its own precision) uses the centred two-pass
    form. Lower precisions take fp32 statistics in the E[x²]−μ² form and
    scale in their own dtype, as the JAX function does."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    if rows is not None and rows.axis.size > 1:
        count = rows.h * x.shape[2]

        def mean(t):
            return spatial_sum(t.sum(dim=(1, 2), keepdim=True, dtype=acc), rows) / count
    else:
        def mean(t):
            return t.mean(dim=(1, 2), keepdim=True, dtype=acc)

    if x.dtype in (torch.float32, torch.float64):
        mu = mean(x)
        var = mean((x - mu).square())
        return (x - mu) * torch.rsqrt(var + eps)
    m = mean(x)
    m2 = mean(x.float().square())
    var = (m2 - m.square()).clamp_min(0.0)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return (x - m.to(x.dtype)) * scale


def group_norm(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, rows: Rows | None = None) -> torch.Tensor:
    """x: (N, H, W, C) -> float32 (N, H, W, C), each sample's groups of
    C / groups channels normalized over (H, W, group) and scaled per channel;
    with ``rows``, x is this rank's row shard of maps of ``rows.h`` rows.

    Flax's arithmetic in every dtype: float32 statistics in the fast-variance
    form max(0, E[x²] − E[x]²), then (x − μ) · (rsqrt(var + eps) · weight) +
    bias (float64 throughout for a float64 x). On row shards the two sums
    travel in one all-reduce. The caller casts the result to its compute
    dtype."""
    n, h, w, c = x.shape
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc).reshape(n, h * w, groups, c // groups)
    if rows is not None and rows.axis.size > 1:
        count = rows.h * w * (c // groups)
        sums = spatial_sum(torch.stack([xf.sum(dim=(1, 3), keepdim=True),
                                        (xf * xf).sum(dim=(1, 3), keepdim=True)]), rows)
        mean, mean2 = sums[0] / count, sums[1] / count
    else:
        mean = xf.mean(dim=(1, 3), keepdim=True)
        mean2 = (xf * xf).mean(dim=(1, 3), keepdim=True)
    var = (mean2 - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight.to(acc).view(1, 1, groups, -1)
    return ((xf - mean) * mul + bias.to(acc).view(1, 1, groups, -1)).reshape(n, h, w, c)
