"""Evaluation metrics on the device, port of ``tfcgan_tpu.ops.metrics``.

- PSNR: 20·log10(255/sqrt(mse)), 100 where mse == 0.
- SSIM: skimage ``structural_similarity`` defaults (uniform 7×7 window,
  K1=0.01, K2=0.03, ddof-1 covariance, valid filtering), per channel and
  averaged for multichannel images.
- Bhattacharyya: 8×8×8 RGB histograms, L2-normalized, OpenCV
  HISTCMP_BHATTACHARYYA.
- FFT magnitude MSE and MAE of log|fftshift(fft2(gray))|.

NCC and mutual information come with the registration eval (``eval-reg``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tfcgan_tpu_torch.ops.fftloss import fft_log_magnitude


def psnr(real: torch.Tensor, fake: torch.Tensor, max_value: float = 255.0) -> torch.Tensor:
    """Per-image PSNR over uint8-scale images. real/fake: (N, ...) float."""
    dims = tuple(range(1, real.dim()))
    mse = (real.float() - fake.float()).square().mean(dim=dims)
    val = 20.0 * torch.log10(max_value / torch.sqrt(mse))
    return torch.where(mse == 0, torch.full_like(val, 100.0), val)


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean filter with 'valid' boundary over (N, H, W) planes."""
    return F.avg_pool2d(x[:, None], size, stride=1)[:, 0]


def ssim(real: torch.Tensor, fake: torch.Tensor, data_range: float = 255.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """skimage-default SSIM per image. real/fake: (N, H, W) or (N, H, W, C)."""
    if real.dim() == 4:
        per_c = [ssim(real[..., c], fake[..., c], data_range, win_size, k1, k2)
                 for c in range(real.shape[-1])]
        return torch.stack(per_c, dim=0).mean(dim=0)
    x, y = real.float(), fake.float()
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    ux, uy = _uniform_filter(x, win_size), _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    # valid filtering already crops skimage's (win_size-1)//2 margin
    return s.mean(dim=(1, 2))


def _hist_rgb8(img: torch.Tensor) -> torch.Tensor:
    """uint8-scale RGB (N, H, W, 3) -> (N, 512) joint histograms, 8 bins per channel."""
    q = torch.clamp(img.to(torch.int32) // 32, 0, 7)
    idx = (q[..., 0] * 64 + q[..., 1] * 8 + q[..., 2]).reshape(img.shape[0], -1)
    idx = idx + 512 * torch.arange(img.shape[0], device=img.device, dtype=idx.dtype)[:, None]
    return torch.bincount(idx.reshape(-1), minlength=512 * img.shape[0]).float().view(-1, 512)


def bhattacharyya(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """OpenCV HISTCMP_BHATTACHARYYA over L2-normalized 8³ RGB histograms.
    real/fake: (N, H, W, 3) uint8-scale. Returns (N,) distances."""
    h1, h2 = _hist_rgb8(real), _hist_rgb8(fake)
    h1 = h1 / torch.clamp_min(torch.linalg.vector_norm(h1, dim=1, keepdim=True), 1e-12)
    h2 = h2 / torch.clamp_min(torch.linalg.vector_norm(h2, dim=1, keepdim=True), 1e-12)
    bins = h1.shape[1]
    num = torch.sqrt(h1 * h2).sum(dim=1)
    den = torch.sqrt(h1.mean(dim=1) * h2.mean(dim=1)) * bins
    return torch.sqrt(torch.clamp_min(1.0 - num / torch.clamp_min(den, 1e-12), 0.0))


def fft_mag_mse(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """MSE of log-magnitude spectra. real/fake: (N, H, W, 3) in [-1, 1]."""
    return (fft_log_magnitude(real) - fft_log_magnitude(fake)).square().mean(dim=(1, 2))


def fft_mag_mae(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """MAE of log-magnitude spectra. real/fake: (N, H, W, 3) in [-1, 1]."""
    return (fft_log_magnitude(real) - fft_log_magnitude(fake)).abs().mean(dim=(1, 2))
