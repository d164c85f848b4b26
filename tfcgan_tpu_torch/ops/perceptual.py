"""The fixed (parameter-free) perceptual anchor, port of
``tfcgan_tpu.ops.perceptual``: an image pyramid (2x2 average pool per level)
scored with L1 plus (1 - NCC) per level. The STN recipes use it where no
converted LPIPS weights exist (``perceptual="auto"``). All reductions run in
float32.
"""

from __future__ import annotations

import torch


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pool on NHWC (even H and W)."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def ncc_loss(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-image normalized cross-correlation over all pixels and channels,
    with an eps-guarded denominator: (N,) in [-1, 1]."""
    x = x.float().flatten(1)
    y = y.float().flatten(1)
    xm = x - x.mean(dim=1, keepdim=True)
    ym = y - y.mean(dim=1, keepdim=True)
    num = (xm * ym).mean(dim=1)
    den = torch.sqrt((xm * xm).mean(dim=1) * (ym * ym).mean(dim=1))
    return num / (den + eps)


def multiscale_recon(x: torch.Tensor, y: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """sum over levels of mean|x - y| + 0.5 * mean(1 - NCC(x, y)), a scalar.
    ``levels`` counts the full resolution; each level halves H and W, pooled
    in the inputs' dtype as the JAX function does."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lv in range(levels):
        total = total + (x.float() - y.float()).abs().mean() + 0.5 * (1.0 - ncc_loss(x, y)).mean()
        if lv + 1 < levels:
            x, y = _avg_pool2(x), _avg_pool2(y)
    return total
