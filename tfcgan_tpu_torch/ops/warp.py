"""Affine grid generation and grid sampling (the direct 2-D STN warp), port of
``tfcgan_tpu.ops.warp``: plain tensor code, NHWC in and out, float32 inside.

Semantics are torch's own ``F.affine_grid`` / ``F.grid_sample``:

- ``affine_grid(theta, (N, H, W), align_corners)``: normalized (x, y)
  coordinates, x along W; ``align_corners=True`` is linspace(-1, 1, W).
- ``grid_sample``: modes "bilinear"/"bicubic"/"nearest", padding
  "zeros"/"border"/"reflection". Bicubic is the cubic convolution kernel with
  A = -0.75, the padding applied per tap.

Gradients reach the image (the scatter-add of the gathers) and the grid
(through the fractional part; ``floor`` contributes zero) by autograd. This is
the ``fast_warp=False`` path of the STN and the oracle the separable warp
(``ops/resample.py``) is held against; ``F.grid_sample`` itself is not called.
"""

from __future__ import annotations

import torch


def affine_grid(theta: torch.Tensor, size: tuple[int, int, int],
                align_corners: bool = True) -> torch.Tensor:
    """theta: (N, 2, 3) -> grid (N, H, W, 2) of normalized (x, y) coordinates."""
    _, h, w = size
    dev = theta.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, dtype=torch.float32, device=dev)
        ys = torch.linspace(-1.0, 1.0, h, dtype=torch.float32, device=dev)
    else:
        xs = (2.0 * torch.arange(w, dtype=torch.float32, device=dev) + 1.0) / w - 1.0
        ys = (2.0 * torch.arange(h, dtype=torch.float32, device=dev) + 1.0) / h - 1.0
    gx, gy = xs[None, None, :], ys[None, :, None]
    th = theta.float()

    def row(i):
        return th[:, i, 0, None, None] * gx + th[:, i, 1, None, None] * gy + th[:, i, 2, None, None]

    return torch.stack([row(0), row(1)], dim=-1)


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """torch's reflect_coordinates: reflect into [lo, hi]."""
    span = hi - lo
    if span <= 0:
        return torch.zeros_like(x) + lo
    x = torch.remainder(torch.abs(x - lo), 2.0 * span)
    return torch.where(x > span, 2.0 * span - x, x) + lo


def _reflect_coord(ix: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        ix = _reflect(ix, 0.0, float(size - 1))
    else:
        ix = _reflect(ix, -0.5, size - 0.5)
    return torch.clamp(ix, 0.0, float(size - 1))


def _gather_2d(inp: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
               padding_mode: str) -> torch.Tensor:
    """inp[n, iy, ix, :] for integer index tensors (N, ...): out-of-range
    taps read the clamped pixel (border, reflection) or 0 (zeros)."""
    n, h, w, c = inp.shape
    ixc, iyc = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
    idx = (iyc * w + ixc).reshape(n, -1, 1).expand(-1, -1, c)
    vals = torch.gather(inp.reshape(n, h * w, c), 1, idx).reshape(*ix.shape, c)
    if padding_mode == "zeros":
        in_range = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        vals = vals * in_range[..., None].to(vals.dtype)
    return vals


def cubic_coeffs(t: torch.Tensor, a: float = -0.75
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weights of the 4 taps at integer offsets (-1, 0, 1, 2) around t in
    [0, 1): torch's get_cubic_upsampling_coefficients, Keys kernel, A = -0.75."""
    def k1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def k2(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t)


def grid_sample(inp: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """inp: (N, H, W, C); grid: (N, Hg, Wg, 2) normalized (x, y) -> (N, Hg, Wg, C)."""
    if mode not in ("nearest", "bilinear", "bicubic"):
        raise ValueError(f"unknown mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    _, h, w, _ = inp.shape
    ix = _unnormalize(grid[..., 0].float(), w, align_corners)
    iy = _unnormalize(grid[..., 1].float(), h, align_corners)
    if mode != "bicubic" and padding_mode == "reflection":
        # torch reflects the base coordinate for nearest/bilinear; bicubic keeps
        # the unnormalized coordinate and bounds each tap instead
        ix = _reflect_coord(ix, w, align_corners)
        iy = _reflect_coord(iy, h, align_corners)

    if mode == "nearest":
        return _gather_2d(inp, torch.round(ix).long(), torch.round(iy).long(), padding_mode)

    x0, y0 = torch.floor(ix), torch.floor(iy)
    tx, ty = ix - x0, iy - y0
    x0i, y0i = x0.long(), y0.long()
    out = 0.0
    if mode == "bilinear":
        for dy, wy in ((0, 1.0 - ty), (1, ty)):
            for dx, wx in ((0, 1.0 - tx), (1, tx)):
                v = _gather_2d(inp, x0i + dx, y0i + dy, padding_mode)
                out = out + v * (wx * wy)[..., None].to(inp.dtype)
        return out

    def bound_tap(idx, size):
        # torch's get_value_bounded: reflect each tap coordinate, then clip;
        # zeros-mode taps are masked in _gather_2d
        if padding_mode == "reflection":
            return torch.round(_reflect_coord(idx.float(), size, align_corners)).long()
        return idx

    wx, wy = cubic_coeffs(tx), cubic_coeffs(ty)
    for j in range(4):
        row = 0.0
        ty_idx = bound_tap(y0i + j - 1, h)
        for i in range(4):
            v = _gather_2d(inp, bound_tap(x0i + i - 1, w), ty_idx, padding_mode)
            row = row + v * wx[i][..., None].to(inp.dtype)
        out = out + row * wy[j][..., None].to(inp.dtype)
    return out


def warp_affine(src: torch.Tensor, theta: torch.Tensor, mode: str = "bicubic",
                padding_mode: str = "border", align_corners: bool = True) -> torch.Tensor:
    """The direct STN warp: per-sample ``affine_grid`` + ``grid_sample``.
    src: (N, H, W, C), theta: (N, 2, 3)."""
    n, h, w, _ = src.shape
    grid = affine_grid(theta, (n, h, w), align_corners=align_corners)
    return grid_sample(src, grid, mode=mode, padding_mode=padding_mode,
                       align_corners=align_corners)
