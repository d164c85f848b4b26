"""The TFC-GAN U-Net generator, port of ``tfcgan_tpu.models.unet.GeneratorUNet``.

6 blur-pool down blocks, 5 up blocks with skip concats, and a nearest-2×
upsample + asymmetric pad + conv + tanh head. Channel plan (256² input):
64-128-256-512-512-512 down / 512-512-256-128-64 up. Parameter names follow
the JAX module tree (``down1.conv.weight`` <- ``down1/conv/kernel``, see
``tfcgan_tpu_torch.bridge``). The label-conditional generator comes with the
debiased family.

Dropout (p = 0.5 in down3, down4, up2 and up3) takes explicit keep-masks:
``draw_dropout_masks`` makes them from a ``torch.Generator``, and in training
mode the forward refuses to run without them. Eval mode runs no dropout.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tfcgan_tpu_torch.models.layers import UNetDown, UNetUp, Upsample2xConv, init_normal_
from tfcgan_tpu_torch.ops.kernels.blurpool import out_len


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

    def dropout_shapes(self, n: int, h: int, w: int) -> dict[str, tuple[int, ...]]:
        """Shapes of the dropout blocks' outputs for an (n, h, w, C) input."""
        sizes = [(h, w)]
        for _ in range(6):  # down blocks: conv(k4, s1, p1) then blur stride 2
            hh, ww = sizes[-1]
            sizes.append((out_len(hh - 1, 2), out_len(ww - 1, 2)))
        up2 = tuple(2 * s for s in sizes[5])  # up blocks: convT doubles, blur s1 keeps
        up3 = tuple(2 * s for s in up2)
        return {"down3": (n, *sizes[3], self.down3.conv.weight.shape[0]),
                "down4": (n, *sizes[4], self.down4.conv.weight.shape[0]),
                "up2": (n, *up2, self.up2.conv.weight.shape[1]),
                "up3": (n, *up3, self.up3.conv.weight.shape[1])}

    def draw_dropout_masks(self, n: int, h: int, w: int, generator: torch.Generator
                           ) -> dict[str, torch.Tensor]:
        """Keep-masks for one forward on an (n, h, w, C) input: Bernoulli(1 - p)
        on ``generator``'s device, scaled by 1/(1-p), in the compute dtype."""
        masks = {}
        for name, shape in self.dropout_shapes(n, h, w).items():
            keep = 1.0 - getattr(self, name).dropout
            u = torch.rand(shape, generator=generator, device=generator.device)
            masks[name] = ((u < keep) / keep).to(self.dtype)
        return masks

    def forward(self, x: torch.Tensor,
                dropout_masks: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
        """In training mode ``dropout_masks`` (from ``draw_dropout_masks``) is
        required; in eval mode it must be None."""
        if self.training and dropout_masks is None:
            raise ValueError("GeneratorUNet in training mode needs dropout_masks "
                             "(draw_dropout_masks); use .eval() for no dropout")
        if not self.training and dropout_masks is not None:
            raise ValueError("dropout_masks given to a GeneratorUNet in eval mode")
        keep = dropout_masks or {}
        x = x.to(self.dtype)
        d1 = self.down1(x)
        d2 = self.down2(d1)
        d3 = self.down3(d2, keep.get("down3"))
        d4 = self.down4(d3, keep.get("down4"))
        d5 = self.down5(d4)
        d6 = self.down6(d5)
        u1 = self.up1(d6, d5)
        u2 = self.up2(u1, d4, keep.get("up2"))
        u3 = self.up3(u2, d3, keep.get("up3"))
        u4 = self.up4(u3, d2)
        u5 = self.up5(u4, d1)
        return torch.tanh(self.final_conv(u5))
