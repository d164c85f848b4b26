"""Image resizing on NHWC tensors, port of ``tfcgan_tpu.ops.resize``.

``avg_pool_2x`` is ThermalGAN's downsample between the pyramid
discriminators: ``nn.AvgPool2d(3, stride=2, padding=1,
count_include_pad=False)``, run by ``F.avg_pool2d`` on the channels_last view
(no layout copy).

``resize_bicubic_torch`` is ``jax.image.resize(method="cubic")``: Keys' cubic
kernel with a = -0.5, widened by 1 / scale when it shrinks the image (the
antialias), each output's weights normalised to sum to one and taps outside
the image left out. ``F.interpolate(mode="bicubic")`` uses a = -0.75 and
clamps at the border, so the separable weights are built here and applied as
two float32 matrix products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tfcgan_tpu_torch.parallel.spatial import Rows, window_op


def _avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1, count_include_pad=False)
    return y.permute(0, 2, 3, 1)


def avg_pool_height(h: int) -> int:
    return (h - 1) // 2 + 1


def avg_pool_2x(x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
    """(N, H, W, C) -> (N, floor((H - 1) / 2) + 1, ..., C): the 3x3 mean at
    stride 2 over the window's pixels inside the image. With ``rows``, this
    rank's rows of both: the windows at the edge of a shard count their
    whole 3 rows (``parallel.spatial.window_op``), only the map's own edges
    leave the padding out."""
    return window_op(x, rows, 3, 2, 1, _avg_pool_2x)


def _keys_cubic(t: torch.Tensor) -> torch.Tensor:
    t = t.abs()
    near = ((1.5 * t - 2.5) * t) * t + 1.0
    far = ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0
    return torch.where(t >= 2.0, torch.zeros_like(t), torch.where(t >= 1.0, far, near))


def cubic_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """The (in_size, out_size) float32 matrix of ``jax.image.resize``'s cubic
    weights along one axis."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)  # widen the kernel only when shrinking
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic_torch(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, out_h, out_w, C), cubic interpolation in float32
    (cast back to x's dtype)."""
    _, h, w, _ = x.shape
    wh = cubic_weights(h, out_hw[0], x.device)
    ww = cubic_weights(w, out_hw[1], x.device)
    y = torch.einsum("nhwc,ho->nowc", x.float(), wh)
    y = torch.einsum("nowc,wp->nopc", y, ww)
    return y.to(x.dtype).contiguous()
