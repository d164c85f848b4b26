"""Fourier spectra and the FFT loss, port of ``tfcgan_tpu.ops.fftloss``.

``fft_log_magnitude`` gives the serve path's spectra and the FFT metrics;
``fft_amp_phase`` and ``fft_l1_loss`` the training loss: rfft2 of the
grayscale plane, fftshifted on both axes (numpy's default, so the half axis
of odd length W//2 + 1 rolls by (W//2 + 1)//2), amplitude and
phase = atan2(imag, real).

The transforms need the whole H: given the ``rows`` record of row-sharded
images (the spatial mesh axis), each gathers the grayscale plane over the
spatial group first (``parallel.spatial.gather_spatial``, as the JAX
functions call ``gather_spatial``), and every rank computes the whole
result. The training recipe gathers the images once before all its
whole-image terms and calls these on whole images (``rows`` None).
"""

from __future__ import annotations

import torch

from tfcgan_tpu_torch.ops.quantize import rgb_to_luma_uint8
from tfcgan_tpu_torch.parallel.spatial import Rows, gather_spatial


def fft_log_magnitude(x: torch.Tensor, mode: str = "eval", rows: Rows | None = None
                      ) -> torch.Tensor:
    """log|fftshift(fft2(gray))| of (N, H, W, 3) images in [-1, 1] -> (N, H, W).

    |f| is floored at the smallest positive normal float32, so a constant
    image gives finite values (log(0) would be -inf); for any other image the
    floor never binds."""
    gray = gather_spatial(rgb_to_luma_uint8(x, mode=mode), rows)
    f = torch.fft.fftshift(torch.fft.fft2(gray), dim=(-2, -1))
    return torch.log(torch.clamp_min(f.abs(), torch.finfo(torch.float32).tiny))


def fft_amp_phase(x: torch.Tensor, mode: str = "exact", rows: Rows | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, 3) in [-1, 1] -> (amp, phase), each (N, H, W//2 + 1)."""
    gray = gather_spatial(rgb_to_luma_uint8(x, mode=mode), rows)
    f = torch.fft.fftshift(torch.fft.rfft2(gray.float()), dim=(-2, -1))
    return f.abs(), torch.atan2(f.imag, f.real)


def fft_l1_loss(fake: torch.Tensor, real: torch.Tensor, mode: str = "exact",
                rows: Rows | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference FFT loss: (0.5 * (amp + phase), amp, phase), each an L1
    mean between fake and real (whole on every rank with ``rows``)."""
    amp_f, pha_f = fft_amp_phase(fake, mode, rows)
    amp_r, pha_r = fft_amp_phase(real, mode, rows)
    loss_amp = (amp_f - amp_r).abs().mean()
    loss_pha = (pha_f - pha_r).abs().mean()
    return 0.5 * (loss_amp + loss_pha), loss_amp, loss_pha
