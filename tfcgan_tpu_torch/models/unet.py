"""The TFC-GAN U-Net generator, port of ``tfcgan_tpu.models.unet.GeneratorUNet``.

6 blur-pool down blocks, 5 up blocks with skip concats, and a nearest-2×
upsample + asymmetric pad + conv + tanh head. Channel plan (256² input):
64-128-256-512-512-512 down / 512-512-256-128-64 up. Parameter names follow
the JAX module tree (``down1.conv.weight`` <- ``down1/conv/kernel``, see
``tfcgan_tpu_torch.bridge``). The label-conditional generator comes with the
debiased family.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tfcgan_tpu_torch.models.layers import UNetDown, UNetUp, Upsample2xConv, init_normal_


class GeneratorUNet(nn.Module):
    """x: (N, H, W, in_channels) in [-1, 1], NHWC -> (N, H, W, out_channels)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.down1 = UNetDown(in_channels, 64, normalize=False, **kw)
        self.down2 = UNetDown(64, 128, **kw)
        self.down3 = UNetDown(128, 256, dropout=0.5, **kw)
        self.down4 = UNetDown(256, 512, dropout=0.5, **kw)
        self.down5 = UNetDown(512, 512, normalize=False, **kw)
        self.down6 = UNetDown(512, 512, **kw)
        self.up1 = UNetUp(512, 512, **kw)
        self.up2 = UNetUp(1024, 512, dropout=0.5, **kw)
        self.up3 = UNetUp(1024, 256, dropout=0.5, **kw)
        self.up4 = UNetUp(512, 128, **kw)
        self.up5 = UNetUp(256, 64, **kw)
        self.final_conv = Upsample2xConv(128, out_channels, **kw)
        init_normal_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        d1 = self.down1(x)
        d2 = self.down2(d1)
        d3 = self.down3(d2)
        d4 = self.down4(d3)
        d5 = self.down5(d4)
        d6 = self.down6(d5)
        u1 = self.up1(d6, d5)
        u2 = self.up2(u1, d4)
        u3 = self.up3(u2, d3)
        u4 = self.up4(u3, d2)
        u5 = self.up5(u4, d1)
        return torch.tanh(self.final_conv(u5))
