"""The ResNet generator (NeMAR's resnet_9blocks translator, the CycleGAN
baseline), port of ``tfcgan_tpu.models.resnet_gen``: reflection-pad 7x7 stem,
two stride-2 convs, N residual blocks (reflection-pad 3x3 convs), two
nearest-2x upsample + conv stages, reflection-pad 7x7 head + tanh; instance
norm after every conv but the head. Parameter names follow the JAX module
tree (``res0.conv1.weight`` <- ``res0/conv1/kernel``, see
``tfcgan_tpu_torch.bridge``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.models.layers import TorchConv, Upsample2xConv, init_normal_
from tfcgan_tpu_torch.ops.norm import instance_norm

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
    return torch.cat([x[:, :, 1:p + 1].flip(2), x, x[:, :, -p - 1:-1].flip(2)], dim=2)


class ResidualBlock(nn.Module):
    """x + norm(conv(pad(relu(norm(conv(pad(x)))))))."""

    def __init__(self, feats: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(kernel_size=3, padding=_NO_PAD, dtype=dtype, device=device)
        self.conv1 = TorchConv(feats, feats, **kw)
        self.conv2 = TorchConv(feats, feats, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(instance_norm(self.conv1(reflect_pad(x, 1))))
        return x + instance_norm(self.conv2(reflect_pad(h, 1)))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(instance_norm(self.stem(reflect_pad(x.to(self.dtype), 3))))
        for i in range(2):
            h = F.relu(instance_norm(getattr(self, f"down{i}")(h)))
        for i in range(self.num_blocks):
            h = getattr(self, f"res{i}")(h)
        for i in range(2):
            h = F.relu(instance_norm(getattr(self, f"up{i}")(h)))
        return torch.tanh(self.head(reflect_pad(h, 3)))
