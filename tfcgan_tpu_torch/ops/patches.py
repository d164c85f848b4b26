"""Row-major patch decomposition, port of ``tfcgan_tpu.ops.patches``."""

from __future__ import annotations

import torch


def patchify(x: torch.Tensor, grid: int) -> torch.Tensor:
    """(N, H, W, C) -> (grid², N, H/grid, W/grid, C); patch p covers block row
    p // grid and block column p % grid."""
    n, h, w, c = x.shape
    ph, pw = h // grid, w // grid
    x = x.reshape(n, grid, ph, grid, pw, c).permute(1, 3, 0, 2, 4, 5)
    return x.reshape(grid * grid, n, ph, pw, c)


def unpatchify(p: torch.Tensor, grid: int) -> torch.Tensor:
    """Inverse of :func:`patchify`."""
    gg, n, ph, pw, c = p.shape
    if gg != grid * grid:
        raise ValueError(f"{gg} patches do not make a {grid}x{grid} grid")
    x = p.reshape(grid, grid, n, ph, pw, c).permute(2, 0, 3, 1, 4, 5)
    return x.reshape(n, grid * ph, grid * pw, c)
