"""The TFC-GAN U-Net generator, port of ``tfcgan_tpu.models.unet.GeneratorUNet``.

6 blur-pool down blocks, 5 up blocks with skip concats, and a nearest-2×
upsample + asymmetric pad + conv + tanh head. Channel plan (256² input):
64-128-256-512-512-512 down / 512-512-256-128-64 up. Parameter names follow
the JAX module tree (``down1.conv.weight`` <- ``down1/conv/kernel``, see
``tfcgan_tpu_torch.bridge``). ``ConditionalGeneratorUNet`` is the debiased
family's label-conditional G: a Dense layer maps the (gender, ethnicity, age)
labels to an H x W plane, the image's 4th input channel.

Dropout (p = 0.5 in down3, down4, up2 and up3) takes explicit keep-masks:
``draw_dropout_masks`` makes them from a ``torch.Generator``, and in training
mode the forward refuses to run without them. Eval mode runs no dropout.

``GeneratorUNet(x, masks, rows=...)`` runs on row shards (the spatial mesh
axis): x is this rank's rows of images of ``rows.h`` rows, the keep-masks
are cut to the blocks' rows, and so is the output. So does
``ConditionalGeneratorUNet(x, labels, masks, rows=...)``: its label plane is
N x H x W values, computed whole on every rank (under the tensor axis
``label_fc`` is column-parallel and gathers its outputs anyway) and cut to
this rank's rows (``split_rows``), so that ``label_fc``'s gradient on a rank
comes from its rows of the plane and the group's sum makes it whole.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tfcgan_tpu_torch.models.layers import UNetDown, UNetUp, Upsample2xConv, init_normal_
from tfcgan_tpu_torch.models.vit import Dense, lecun_normal_
from tfcgan_tpu_torch.ops.kernels.blurpool import out_len
from tfcgan_tpu_torch.parallel.spatial import Rows, split_rows


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
        return {"down3": (n, *sizes[3], self.down3.conv.features),
                "down4": (n, *sizes[4], self.down4.conv.features),
                "up2": (n, *up2, self.up2.conv.features),
                "up3": (n, *up3, self.up3.conv.features)}

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

    def forward(self, x: torch.Tensor, dropout_masks: dict[str, torch.Tensor] | None = None,
                rows: Rows | None = None) -> torch.Tensor:
        """In training mode ``dropout_masks`` (from ``draw_dropout_masks``) is
        required; in eval mode it must be None. With ``rows`` x is a row
        shard (see the module docstring)."""
        if self.training and dropout_masks is None:
            raise ValueError("GeneratorUNet in training mode needs dropout_masks "
                             "(draw_dropout_masks); use .eval() for no dropout")
        if not self.training and dropout_masks is not None:
            raise ValueError("dropout_masks given to a GeneratorUNet in eval mode")
        keep = dropout_masks or {}
        x = x.to(self.dtype)
        r = [rows]  # the records of x, d1, ..., d6
        for _ in range(6):
            r.append(r[-1] and r[-1].of(UNetDown.out_height(r[-1].h)))
        d1 = self.down1(x, rows=r[0])
        d2 = self.down2(d1, rows=r[1])
        d3 = self.down3(d2, keep.get("down3"), r[2])
        d4 = self.down4(d3, keep.get("down4"), r[3])
        d5 = self.down5(d4, rows=r[4])
        d6 = self.down6(d5, rows=r[5])
        u1 = self.up1(d6, d5, rows=r[6])
        u2 = self.up2(u1, d4, keep.get("up2"), r[5])
        u3 = self.up3(u2, d3, keep.get("up3"), r[4])
        u4 = self.up4(u3, d2, rows=r[3])
        u5 = self.up5(u4, d1, rows=r[2])
        return torch.tanh(self.final_conv(u5, r[1]))


class ConditionalGeneratorUNet(nn.Module):
    """(x (N, H, W, C), labels (N, 3) float) -> (N, H, W, out_channels):
    ``label_fc`` takes the labels to an H x W plane, concatenated to x as an
    extra input channel of the inner ``unet``. The image side is fixed at
    construction (the Dense layer's width is H x W)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, image_size: int = 256,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        # the labels: (gender, ethnicity, age)
        self.label_fc = Dense(3, image_size * image_size, dtype=dtype, device=device)
        self.unet = GeneratorUNet(in_channels + 1, out_channels, dtype=dtype, device=device,
                                  generator=generator)
        lecun_normal_(self.label_fc, generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX init's distributions, drawn on the CPU from ``generator``:
        the U-Net's kernels normal(0, 0.02), ``label_fc`` lecun-normal, zero biases."""
        init_normal_(self.unet, generator)
        lecun_normal_(self.label_fc, generator)

    def draw_dropout_masks(self, n: int, h: int, w: int, generator: torch.Generator
                           ) -> dict[str, torch.Tensor]:
        return self.unet.draw_dropout_masks(n, h, w, generator)

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                dropout_masks: dict[str, torch.Tensor] | None = None,
                rows: Rows | None = None) -> torch.Tensor:
        """With ``rows`` x is a row shard of images of ``rows.h`` rows (see
        the module docstring)."""
        n, h, w, _ = x.shape
        plane = self.label_plane(labels, n, h if rows is None else rows.h, w, rows)
        return self.unet(torch.cat([x.to(self.dtype), plane], dim=-1), dropout_masks, rows)

    def label_plane(self, labels: torch.Tensor, n: int, h: int, w: int,
                    rows: Rows | None = None) -> torch.Tensor:
        """The (N, H, W, 1) plane of the labels, or with ``rows`` this rank's
        rows of it."""
        return split_rows(self.label_fc(labels.to(self.dtype)).reshape(n, h, w, 1), rows)
