"""2×2/stride-2 max-pool on NHWC, port of ``tfcgan_tpu.ops.pooling.pool22``.

``F.max_pool2d`` on the channels_last view of the NHWC tensor, so no layout
copy. Its gradient goes to the first maximum of each window in row-major
order, as XLA's does. With ``rows`` (the spatial mesh axis) it pools this
rank's rows of the output, fetching a neighbour's row where a window
straddles two shards.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tfcgan_tpu_torch.parallel.spatial import Rows, row_op


def _pool(h: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def pool22(h: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, C); with ``rows``, row shards of both."""
    if rows is None or rows.axis.size == 1:
        return _pool(h)
    return row_op(h, rows, rows.h // 2, lambda lo, hi: (2 * lo, 2 * hi),
                  lambda xw, a, b, lo, hi: _pool(xw))
