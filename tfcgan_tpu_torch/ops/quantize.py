"""Grayscale conversion of normalized images, port of ``tfcgan_tpu.ops.quantize``.

Three modes: ``eval`` (the image as saved to PNG and re-read, then PIL's
fixed-point ITU-R 601 luma: the serve and eval path), ``exact`` (the
reference training losses' host path, ``ToPILImage`` on a [-1, 1] tensor,
i.e. trunc(x * 255) wrapped mod 256, then PIL luma; zero gradient) and
``smooth`` (float luma without quantization, differentiable).
"""

from __future__ import annotations

import torch

_LUMA_R, _LUMA_G, _LUMA_B = 19595.0, 38470.0, 7471.0  # /65536 fixed point


def quantize_uint8_torch(x: torch.Tensor) -> torch.Tensor:
    """torch ``ToPILImage`` on a float tensor: trunc(x * 255) wrapped mod 256,
    as float32 values in [0, 255], with zero gradient."""
    return torch.remainder(torch.trunc(x.detach().float() * 255.0), 256.0)


def luma_pil(rgb_uint8: torch.Tensor) -> torch.Tensor:
    """uint8-valued float RGB (..., 3) -> PIL-exact L values (...,) in [0, 255].
    Every partial sum stays below 2^24, so float32 holds it exactly."""
    r, g, b = rgb_uint8[..., 0], rgb_uint8[..., 1], rgb_uint8[..., 2]
    acc = r * _LUMA_R + g * _LUMA_G + b * _LUMA_B + 32768.0
    return torch.floor(acc / 65536.0)


def rgb_to_luma_uint8(x: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    """Normalized image (N, H, W, 3) in [-1, 1] -> grayscale plane (N, H, W).

    mode="eval":   round-and-clip to the on-disk uint8, then PIL luma.
    mode="exact":  ``quantize_uint8_torch`` of x itself, then PIL luma.
    mode="smooth": [-1, 1] -> [0, 255] floats with the luma weights, no
                   quantization.
    """
    if mode == "exact":
        return luma_pil(quantize_uint8_torch(x))
    v = (x.float() * 0.5 + 0.5) * 255.0
    if mode == "eval":
        return luma_pil(torch.clamp(torch.round(v), 0.0, 255.0))
    if mode == "smooth":
        return (v[..., 0] * (_LUMA_R / 65536.0) + v[..., 1] * (_LUMA_G / 65536.0)
                + v[..., 2] * (_LUMA_B / 65536.0))
    raise ValueError(f"unknown mode {mode!r} (one of 'eval', 'exact', 'smooth')")
