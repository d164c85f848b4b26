"""Fourier log-magnitude spectra, port of ``tfcgan_tpu.ops.fftloss``.

Only ``fft_log_magnitude`` (the serve path's spectra and the FFT metrics) is
ported here; the amplitude/phase loss comes with the training slice.
"""

from __future__ import annotations

import torch

from tfcgan_tpu_torch.ops.quantize import rgb_to_luma_uint8


def fft_log_magnitude(x: torch.Tensor, mode: str = "eval") -> torch.Tensor:
    """log|fftshift(fft2(gray))| of (N, H, W, 3) images in [-1, 1] -> (N, H, W).

    |f| is floored at the smallest positive normal float32, so a constant
    image gives finite values (log(0) would be -inf); for any other image the
    floor never binds."""
    gray = rgb_to_luma_uint8(x, mode=mode)
    f = torch.fft.fftshift(torch.fft.fft2(gray), dim=(-2, -1))
    return torch.log(torch.clamp_min(f.abs(), torch.finfo(torch.float32).tiny))
