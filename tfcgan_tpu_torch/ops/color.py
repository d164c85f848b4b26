"""Grayscale, HSV and torchvision-style ColorJitter on NHWC batches, port of
``tfcgan_tpu.ops.color``.

The reference draws its temperature-triplet negatives from
``ColorJitter(brightness=0.5, contrast=0.75, saturation=1.5, hue=0.5)`` on
``real_B``. The factors and the op order are arguments here (the recipe
draws them), so the same draws can be given to the JAX package in tests.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

_GRAY_W = (0.2989, 0.587, 0.114)

# ColorJitter(brightness=0.5, contrast=0.75, saturation=1.5, hue=0.5): the
# uniform range of each factor, in the order (brightness, contrast,
# saturation, hue) of ``color_jitter``'s ``factors``
JITTER_RANGES = ((0.5, 1.5), (0.25, 1.75), (0.0, 2.5), (-0.5, 0.5))


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) in [0, 1] -> (..., 1), torchvision's weights."""
    w = torch.tensor(_GRAY_W, dtype=x.dtype, device=x.device)
    return (x * w).sum(dim=-1, keepdim=True)


def rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> HSV in [0, 1] (torchvision ``_rgb2hsv``)."""
    r, g, b = x.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(eqc, ones, maxc)
    cr_divisor = torch.where(eqc, ones, cr)
    rc, gc, bc = ((maxc - ch) / cr_divisor for ch in (r, g, b))
    hr = (maxc == r) * (bc - gc)
    hg = ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
    hb = ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    h = torch.remainder((hr + hg + hb) / 6.0 + 1.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV in [0, 1] -> RGB (torchvision ``_hsv2rgb``)."""
    h, s, v = x.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = torch.remainder(i.long(), 6).unsqueeze(-1)
    p = torch.clamp(v * (1.0 - s), 0.0, 1.0)
    q = torch.clamp(v * (1.0 - s * f), 0.0, 1.0)
    t = torch.clamp(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)

    def pick(*opts):
        return torch.gather(torch.stack(opts, dim=-1), -1, i).squeeze(-1)

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def adjust_brightness(x: torch.Tensor, f) -> torch.Tensor:
    return torch.clamp(x * f, 0.0, 1.0)


def adjust_contrast(x: torch.Tensor, f) -> torch.Tensor:
    """Blend with each image's mean gray level (torchvision adjust_contrast)."""
    mean = rgb_to_grayscale(x).mean(dim=(-3, -2, -1), keepdim=True)
    return torch.clamp(f * x + (1.0 - f) * mean, 0.0, 1.0)


def adjust_saturation(x: torch.Tensor, f) -> torch.Tensor:
    return torch.clamp(f * x + (1.0 - f) * rgb_to_grayscale(x), 0.0, 1.0)


def adjust_hue(x: torch.Tensor, delta) -> torch.Tensor:
    h, s, v = rgb_to_hsv(torch.clamp(x, 0.0, 1.0)).unbind(-1)
    return hsv_to_rgb(torch.stack([torch.remainder(h + delta, 1.0), s, v], dim=-1))


_OPS = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def color_jitter(x: torch.Tensor, factors: torch.Tensor, order: Sequence[int]) -> torch.Tensor:
    """ColorJitter of a batch (N, H, W, 3) in [-1, 1] -> float32 in [-1, 1].

    ``factors``: (4,) brightness, contrast, saturation and hue factors, one
    draw for the whole batch (``JITTER_RANGES``); ``order``: a permutation of
    range(4), the order the four ops run in, in [0, 1] space."""
    y = torch.clamp(x.float() * 0.5 + 0.5, 0.0, 1.0)
    for i in order:
        y = _OPS[int(i)](y, factors[int(i)])
    return y * 2.0 - 1.0
