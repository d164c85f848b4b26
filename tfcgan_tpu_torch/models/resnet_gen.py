"""The ResNet generator (NeMAR's resnet_9blocks translator, the CycleGAN
baseline), port of ``tfcgan_tpu.models.resnet_gen``: reflection-pad 7x7 stem,
two stride-2 convs, N residual blocks (reflection-pad 3x3 convs), two
nearest-2x upsample + conv stages, reflection-pad 7x7 head + tanh; instance
norm after every conv but the head. Parameter names follow the JAX module
tree (``res0.conv1.weight`` <- ``res0/conv1/kernel``, see
``tfcgan_tpu_torch.bridge``).

With ``rows`` (the spatial mesh axis) the generator runs on this rank's rows
of the image: each reflection-padded conv fetches its halo rows and, at the
map's global top and bottom, the rows that the reflection mirrors, in one
exchange (``parallel.spatial.row_op(edge="reflect")``); the columns are
reflected on every rank. The stride-2 convs and the upsample stages fetch
their halos as the zero-padded layers do, and the instance norms sum their
statistics over the spatial group.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.models.layers import TorchConv, Upsample2xConv, init_normal_, sharded
from tfcgan_tpu_torch.ops.norm import instance_norm
from tfcgan_tpu_torch.parallel.spatial import Rows, row_op

_NO_PAD = ((0, 0), (0, 0))
_PAD1 = ((1, 1), (1, 1))


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflection pad (the edge sample not repeated) of H and W of an NHWC
    tensor by ``p`` on each side, as two concatenations with flipped slices:
    the result stays NHWC-contiguous and the backward is dense slice adds
    (``F.pad(mode="reflect")`` wants NCHW memory and scatters with atomics)."""
    if not 0 <= p < min(x.shape[1], x.shape[2]):
        raise ValueError(f"reflect_pad by {p} needs an image larger than that, got "
                         f"{tuple(x.shape)}")
    if p == 0:
        return x
    x = torch.cat([x[:, 1:p + 1].flip(1), x, x[:, -p - 1:-1].flip(1)], dim=1)
    return _reflect_cols(x, p)


def _reflect_cols(x: torch.Tensor, p: int) -> torch.Tensor:
    return torch.cat([x[:, :, 1:p + 1].flip(2), x, x[:, :, -p - 1:-1].flip(2)], dim=2)


def reflect_conv(conv: TorchConv, x: torch.Tensor, p: int, rows: Rows | None = None
                 ) -> torch.Tensor:
    """``conv`` (stride 1, no padding of its own) on ``x`` reflection-padded
    by ``p``; with ``rows``, on this rank's rows of a map of ``rows.h`` rows."""
    if not sharded(rows):
        return conv(reflect_pad(x, p))
    if not 0 <= p < min(rows.h, x.shape[2]):
        raise ValueError(f"reflect_pad by {p} needs an image larger than that, got "
                         f"{rows.h} x {x.shape[2]}")
    k = conv.weight.shape[2]
    return row_op(x, rows, rows.h + 2 * p - k + 1, lambda lo, hi: (lo - p, hi - 1 - p + k),
                  lambda xw, a, b, lo, hi: conv._run(_reflect_cols(xw, p), _NO_PAD),
                  edge="reflect")


class ResidualBlock(nn.Module):
    """x + norm(conv(pad(relu(norm(conv(pad(x)))))))."""

    def __init__(self, feats: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(kernel_size=3, padding=_NO_PAD, dtype=dtype, device=device)
        self.conv1 = TorchConv(feats, feats, **kw)
        self.conv2 = TorchConv(feats, feats, **kw)

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        h = F.relu(instance_norm(reflect_conv(self.conv1, x, 1, rows), rows=rows))
        return x + instance_norm(reflect_conv(self.conv2, h, 1, rows), rows=rows)


class ResNetGenerator(nn.Module):
    """x: (N, H, W, in_channels) in [-1, 1], NHWC -> (N, H, W, out_channels)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, num_blocks: int = 9,
                 base_feats: int = 64, dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.num_blocks = dtype, num_blocks
        kw = dict(dtype=dtype, device=device)
        f = base_feats
        self.stem = TorchConv(in_channels, f, kernel_size=7, padding=_NO_PAD, **kw)
        for i in range(2):
            setattr(self, f"down{i}", TorchConv(f, 2 * f, kernel_size=3, stride=2,
                                                padding=_PAD1, **kw))
            f *= 2
        for i in range(num_blocks):
            setattr(self, f"res{i}", ResidualBlock(f, **kw))
        for i in range(2):
            setattr(self, f"up{i}", Upsample2xConv(f, f // 2, kernel_size=3, padding=_PAD1,
                                                   **kw))
            f //= 2
        self.head = TorchConv(f, out_channels, kernel_size=7, padding=_NO_PAD, **kw)
        init_normal_(self, generator)

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        """With ``rows``, ``x`` and the result are this rank's rows of images
        of ``rows.h`` rows."""
        h = F.relu(instance_norm(reflect_conv(self.stem, x.to(self.dtype), 3, rows), rows=rows))
        for i in range(2):
            conv = getattr(self, f"down{i}")
            h = conv(h, rows)
            rows = rows and rows.of(conv.out_height(rows.h))
            h = F.relu(instance_norm(h, rows=rows))
        for i in range(self.num_blocks):
            h = getattr(self, f"res{i}")(h, rows)
        for i in range(2):
            up = getattr(self, f"up{i}")
            h = up(h, rows)
            rows = rows and rows.of(up.out_height(rows.h))
            h = F.relu(instance_norm(h, rows=rows))
        return torch.tanh(reflect_conv(self.head, h, 3, rows))
