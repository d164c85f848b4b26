"""Discriminators, port of ``tfcgan_tpu.models.discriminator``: the TFC-GAN
relativistic ``PatchDiscriminator`` and NeMAR's ``NLayerDiscriminator`` (the
70x70 PatchGAN: stride-2 convs with instance norm) and ``PixelDiscriminator``
(a 1x1 conv stack), both on an already concatenated input.

``PatchDiscriminator``:

4 x (spectral-norm conv(k4, s1, p1) -> leaky_relu(0.2) -> blur_pool stride 2)
over the channel concat of (img_a, img_b), then ZeroPad2d((1, 0, 1, 0)) +
conv(k4, p1, no bias) as one conv with padding ((2, 1), (2, 1)): 16 x 16
logits for a 256² input. Parameter and buffer names follow the JAX module
tree (``block0_conv.weight`` <- ``block0_conv/kernel``, ``block0_conv.u`` <-
``spectral/block0_conv/u``; see ``tfcgan_tpu_torch.bridge``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.models.layers import SpectralConv, TorchConv, init_normal_
from tfcgan_tpu_torch.ops.blurpool import blur_pool
from tfcgan_tpu_torch.ops.norm import instance_norm

WIDTHS = (64, 128, 256, 512)


class PatchDiscriminator(nn.Module):
    """(img_a, img_b) NHWC -> (N, H/16, W/16, 1) logits."""

    def __init__(self, in_channels: int = 6, dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        cin = in_channels
        for i, feats in enumerate(WIDTHS):
            setattr(self, f"block{i}_conv", SpectralConv(cin, feats, dtype=dtype, device=device))
            cin = feats
        self.final_conv = TorchConv(cin, 1, padding=((2, 1), (2, 1)), use_bias=False,
                                    dtype=dtype, device=device)
        self.reset_parameters(generator)

    def blocks(self) -> list[SpectralConv]:
        return [getattr(self, f"block{i}_conv") for i in range(len(WIDTHS))]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Kernels normal(0, 0.02) and zero biases, as the JAX init; u a
        normalized normal draw, v the normalized ones vector. Drawn on the CPU
        from ``generator``."""
        init_normal_(self, generator)
        for block in self.blocks():
            u = torch.randn(block.u.shape, generator=generator)
            block.u = (u / u.norm()).to(block.u.device)
            block.v = torch.full_like(block.v, block.v.numel() ** -0.5)

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
        x = torch.cat([img_a, img_b], dim=-1).to(self.dtype)
        for block in self.blocks():
            x = blur_pool(F.leaky_relu(block(x), 0.2), stride=2)
        return self.final_conv(x)


class NLayerDiscriminator(nn.Module):
    """x: (N, H, W, in_channels) -> logits (N, H/8 - 2, W/8 - 2, 1) for
    ``n_layers=3``: conv(k4, s2) + leaky, ``n_layers - 1`` x (conv(k4, s2) +
    instance norm + leaky), conv(k4, s1) + instance norm + leaky, conv(k4, s1)."""

    def __init__(self, in_channels: int = 6, ndf: int = 64, n_layers: int = 3,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.n_layers = dtype, n_layers
        kw = dict(dtype=dtype, device=device)
        self.conv0 = TorchConv(in_channels, ndf, stride=2, **kw)
        nf = ndf
        for i in range(1, n_layers + 1):
            nf_out = min(nf * 2, ndf * 8)
            setattr(self, f"conv{i}", TorchConv(nf, nf_out, stride=2 if i < n_layers else 1, **kw))
            nf = nf_out
        self.final = TorchConv(nf, 1, **kw)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_normal_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv0(x.to(self.dtype)), 0.2)
        for i in range(1, self.n_layers + 1):
            x = F.leaky_relu(instance_norm(getattr(self, f"conv{i}")(x)), 0.2)
        return self.final(x)


class PixelDiscriminator(nn.Module):
    """x: (N, H, W, in_channels) -> per-pixel logits (N, H, W, 1): three 1x1
    convs, instance norm after the second."""

    def __init__(self, in_channels: int = 6, ndf: int = 64, dtype: torch.dtype = torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(kernel_size=1, padding=((0, 0), (0, 0)), dtype=dtype, device=device)
        self.conv0 = TorchConv(in_channels, ndf, **kw)
        self.conv1 = TorchConv(ndf, 2 * ndf, **kw)
        self.final = TorchConv(2 * ndf, 1, **kw)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_normal_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv0(x.to(self.dtype)), 0.2)
        x = F.leaky_relu(instance_norm(self.conv1(x)), 0.2)
        return self.final(x)
