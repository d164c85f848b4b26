"""Per-pixel temperature maps, port of ``tfcgan_tpu.ops.temperature``.

The reference maps each uint8 red-channel value through
``np.linspace(24, 38, 256)``; that table is affine, 24 + 14 * v / 255.
"""

from __future__ import annotations

import torch

from tfcgan_tpu_torch.ops.quantize import quantize_uint8_torch

TEMP_MIN_C = 24.0
TEMP_MAX_C = 38.0
_SCALE = (TEMP_MAX_C - TEMP_MIN_C) / 255.0


def temperature_lut(x: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    """(N, H, W, C) in [-1, 1] -> (N, H, W) float32 Celsius from the red channel.

    mode="exact":  the ``ToPILImage`` uint8 of the red channel (wraps
                   negatives), zero gradient.
    mode="smooth": the affine map of the red channel, differentiable."""
    red = x[..., 0]
    if mode == "exact":
        v = quantize_uint8_torch(red)
    elif mode == "smooth":
        v = (red.float() * 0.5 + 0.5) * 255.0
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return TEMP_MIN_C + v * _SCALE


def temperature_lut_uint8(img_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 (or uint8-valued float) red channel -> Celsius, for real images."""
    return TEMP_MIN_C + img_uint8.float() * _SCALE
