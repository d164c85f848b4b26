"""2×2/stride-2 max-pool on NHWC, port of ``tfcgan_tpu.ops.pooling.pool22``.

``F.max_pool2d`` on the channels_last view of the NHWC tensor, so no layout
copy. Its gradient goes to the first maximum of each window in row-major
order, as XLA's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pool22(h: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, C)."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
