"""Laplacian-of-Gaussian saliency mask of the Gaussian-mask experiment, port
of ``tfcgan_tpu.ops.saliency``:

    mask = |laplacian_7(gray)|
    mask = (mask - min) / (max - min)    # min and max over the WHOLE batch
    mask = gaussian_blur_9x9,sigma1.6(mask)
    mask = mask / max                    # over the whole batch

kornia's semantics: grayscale 0.299 R + 0.587 G + 0.114 B (not
``ops.color``'s 0.2989), the Laplacian kernel all ones with centre 1 - k²
divided by its absolute sum, the Gaussian the sampled exp(-x² / 2 sigma²)
normalised to sum 1 and applied along W then H, every filter on a reflect
padded map. The batch-global normalisation couples the samples of a batch,
as the reference's does; in a data-parallel step the min and max are the
global batch's (``parallel.mesh.all_reduce_min``/``all_reduce_max``), as
GSPMD computes them over the sharded batch. All in float32 whatever the compute dtype: plain
convolutions without TF32 (``ops.exact``), no kernel of the port's own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tfcgan_tpu_torch.ops.exact import conv2d_fp32
from tfcgan_tpu_torch.parallel.mesh import active_mesh, all_reduce_max, all_reduce_min

_GRAY = (0.299, 0.587, 0.114)


def laplacian_kernel2d(size: int) -> torch.Tensor:
    """Ones with centre ``1 - size²``, divided by the kernel's absolute sum."""
    k = torch.ones((size, size), dtype=torch.float32)
    k[size // 2, size // 2] = 1.0 - size * size
    return k / k.abs().sum()


def gaussian_kernel1d(size: int, sigma: float) -> torch.Tensor:
    """The sampled Gaussian, normalised to sum 1."""
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma * sigma))
    return g / g.sum()


def rgb_to_grayscale_kornia(img: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) -> (N, H, W, 1) float32, kornia's weights."""
    w = torch.tensor(_GRAY, dtype=torch.float32, device=img.device)
    return (img.float() * w).sum(dim=-1, keepdim=True)


def _filter2d_reflect(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """(N, 1, H, W) float32 filtered by ``kernel`` on a reflect-padded map."""
    kh, kw = kernel.shape
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), mode="reflect")
    return conv2d_fp32(x, kernel.to(x.device))


def gaussian_blur(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (N, 1, H, W): along W, then along H."""
    g = gaussian_kernel1d(size, sigma)
    return _filter2d_reflect(_filter2d_reflect(x, g[None, :]), g[:, None])


def saliency_mask(img: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) images (any range) -> (N, H, W, 1) float32 in [0, 1]."""
    gray = rgb_to_grayscale_kornia(img) if img.shape[-1] == 3 else img.float()
    lap = _filter2d_reflect(gray.permute(0, 3, 1, 2), laplacian_kernel2d(7)).abs()
    mesh = active_mesh()  # inside a data-parallel step: the global batch's min and max
    lo, hi = all_reduce_min(lap, mesh), all_reduce_max(lap, mesh)
    norm = (lap - lo) / torch.clamp_min(hi - lo, 1e-12)
    blur = gaussian_blur(norm, 9, 1.6)
    return (blur / torch.clamp_min(all_reduce_max(blur, mesh), 1e-12)).permute(0, 2, 3, 1)
