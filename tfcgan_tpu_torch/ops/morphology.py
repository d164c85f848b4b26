"""Grayscale morphology with the 3x3 cross, port of ``tfcgan_tpu.ops.morphology``.

kornia semantics (``kornia.morphology.gradient`` with a cross kernel): flat
structuring element, 'geodesic' border (the border sees only valid pixels:
``max_pool2d`` pads with -inf), gradient = dilation - erosion. The cross is the
union of a 3x1 and a 1x3 window, so dilation = max(pool 3x1, pool 1x3).

At a tie between two pixels of a window the gradient goes to one of them, and
which one is the framework's choice: only tie-free inputs have one gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gray_dilation(x: torch.Tensor) -> torch.Tensor:
    """Flat dilation with the 3x3 cross, geodesic border. x: (N, H, W, C)."""
    z = x.permute(0, 3, 1, 2)
    v = F.max_pool2d(z, (3, 1), stride=1, padding=(1, 0))
    h = F.max_pool2d(z, (1, 3), stride=1, padding=(0, 1))
    return torch.maximum(v, h).permute(0, 2, 3, 1)


def gray_erosion(x: torch.Tensor) -> torch.Tensor:
    """Flat erosion with the 3x3 cross, geodesic border."""
    return -gray_dilation(-x)


def morphological_gradient(x: torch.Tensor) -> torch.Tensor:
    """kornia ``morph.gradient`` with the cross kernel: dilation - erosion."""
    return gray_dilation(x) - gray_erosion(x)
