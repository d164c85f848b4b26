"""Discriminators, port of ``tfcgan_tpu.models.discriminator``: the TFC-GAN
relativistic ``PatchDiscriminator``, the debiased family's
``AuxClassifierDiscriminator`` (the PatchDiscriminator plus softmax label
heads) and NeMAR's ``NLayerDiscriminator`` (the
70x70 PatchGAN: stride-2 convs with instance norm) and ``PixelDiscriminator``
(a 1x1 conv stack), both on an already concatenated input; the
``StridedPatchDiscriminator`` of ThermalGAN and CycleGAN (stride-2 convs with
instance norm, a head per family) and ThermalGAN's three-scale
``MultiDiscriminator`` with ``multiscale_loss``.

``PatchDiscriminator``:

4 x (spectral-norm conv(k4, s1, p1) -> leaky_relu(0.2) -> blur_pool stride 2)
over the channel concat of (img_a, img_b), then ZeroPad2d((1, 0, 1, 0)) +
conv(k4, p1, no bias) as one conv with padding ((2, 1), (2, 1)): 16 x 16
logits for a 256² input. Parameter and buffer names follow the JAX module
tree (``block0_conv.weight`` <- ``block0_conv/kernel``, ``block0_conv.u`` <-
``spectral/block0_conv/u``; see ``tfcgan_tpu_torch.bridge``). With ``rows``
(the spatial mesh axis) it runs on this rank's rows of the images and
returns its rows of the logits, whose record ``out_rows`` gives. So do
``NLayerDiscriminator``, ``StridedPatchDiscriminator`` (their convs fetch
their halo rows, their instance norms sum over the spatial group) and
``MultiDiscriminator``, whose 2x average pool between the scales runs on
rows too (``ops.resize.avg_pool_2x``) and whose ``out_rows`` is a list, one
record a scale; ``lsgan_loss`` and ``multiscale_loss`` then take those
records and give this rank's share of their means. ``AuxClassifierDiscriminator``
runs its ``patch`` on rows as well, and each of its heads as a row-sharded
product: a rank's rows of the flattened input are the contiguous
in-features [lo W 2C, hi W 2C) of the NHWC order, which it multiplies by
those columns of the head's weight; the partials, kept in float32 (or
wider), are summed over the spatial group (``spatial_sum``), and the bias is
added once, after the sum. Every rank then holds the same probabilities.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.models.layers import SpectralConv, TorchConv, draws_on, init_normal_
from tfcgan_tpu_torch.models.vit import Dense, lecun_normal_
from tfcgan_tpu_torch.ops.blurpool import blur_pool
from tfcgan_tpu_torch.ops.norm import instance_norm
from tfcgan_tpu_torch.ops.resize import avg_pool_2x, avg_pool_height
from tfcgan_tpu_torch.ops.kernels.blurpool import out_len
from tfcgan_tpu_torch.parallel.spatial import Rows, share_mean, spatial_sum
from tfcgan_tpu_torch.parallel.tensor import column_parallel

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
        if not draws_on():
            return
        init_normal_(self, generator)
        for block in self.blocks():
            u = torch.randn(block.u.shape, generator=generator)
            block.u = (u / u.norm()).to(block.u.device)
            block.v = torch.full_like(block.v, block.v.numel() ** -0.5)

    def out_rows(self, rows: Rows | None) -> Rows | None:
        """The record of the logits for images of record ``rows``."""
        if rows is None:
            return None
        h = rows.h
        for _ in self.blocks():
            h = out_len(h - 1, 2)
        return rows.of(self.final_conv.out_height(h))

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor,
                rows: Rows | None = None) -> torch.Tensor:
        x = torch.cat([img_a, img_b], dim=-1).to(self.dtype)
        for block in self.blocks():
            x = F.leaky_relu(block(x, rows), 0.2)
            rows = rows and rows.of(block.out_height(rows.h))
            x = blur_pool(x, 2, rows)
            rows = rows and rows.of(out_len(rows.h, 2))
        return self.final_conv(x, rows)


class AuxClassifierDiscriminator(nn.Module):
    """(img_a, img_b) NHWC -> (logits, probs): the ``patch`` discriminator's
    logits, and softmax heads, each a Dense layer over concat(img_a, img_b)
    flattened in NHWC order (H x W x 2C features: 393,216 at 256²), as the
    JAX module flattens it. With ``num_gender`` > 0 (V1-V5) probs is the
    (gender, ethnicity, age) tuple of the ``aux_gender``, ``aux_ethn`` and
    ``aux_age`` heads, in the reference's head order; else (V6, V7) the
    ethnicity head's alone. With ``rows`` (the spatial axis) the images are
    this rank's rows, the logits its rows of the patch logits (record
    ``out_rows``) and the probabilities whole (see the module docstring)."""

    def __init__(self, in_channels: int = 6, image_size: int = 256, num_classes: int = 4,
                 num_gender: int = 0, num_age: int = 0, dtype: torch.dtype = torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.patch = PatchDiscriminator(in_channels, dtype=dtype, device=device)
        feats = image_size * image_size * in_channels
        kw = dict(dtype=dtype, device=device)
        self.aux_ethn = Dense(feats, num_classes, **kw)
        self.multi_head = num_gender > 0
        if self.multi_head:
            self.aux_gender = Dense(feats, num_gender, **kw)
            self.aux_age = Dense(feats, num_age, **kw)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The patch discriminator's init (kernels normal(0, 0.02), u and v),
        then the heads lecun-normal with zero biases, as flax's Dense."""
        self.patch.reset_parameters(generator)
        for head in self.heads():
            lecun_normal_(head, generator)

    def heads(self) -> list[Dense]:
        return [self.aux_gender, self.aux_ethn, self.aux_age] if self.multi_head \
            else [self.aux_ethn]

    def out_rows(self, rows: Rows | None) -> Rows | None:
        """The record of the patch logits for images of record ``rows``."""
        return self.patch.out_rows(rows)

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor, rows: Rows | None = None):
        logits = self.patch(img_a, img_b, rows)
        flat = torch.cat([img_a, img_b], dim=-1).reshape(img_a.shape[0], -1).to(self.dtype)
        probs = [torch.softmax(head(flat) if rows is None else row_sharded_dense(head, flat, rows),
                               dim=-1) for head in self.heads()]
        return logits, (tuple(probs) if self.multi_head else probs[0])


def row_sharded_dense(head: Dense, flat: torch.Tensor, rows: Rows) -> torch.Tensor:
    """``head(x)`` for the flattened NHWC images x of which ``flat`` holds
    this rank's rows (record ``rows``): the product of ``flat`` with its
    columns of the weight, in float32 (or the compute dtype where that is
    wider), summed over the spatial group, then the bias, then the compute
    dtype; column-parallel over a tensor group where ``head`` is sharded."""
    per_row = head.weight.shape[1] // rows.h
    lo, hi = rows.lo * per_row, rows.hi * per_row
    acc = torch.promote_types(head.dtype, torch.float32)

    def compute(x, weight, bias):
        part = x.to(head.dtype).to(acc) @ weight[:, lo:hi].to(head.dtype).to(acc).t()
        y = spatial_sum(part, rows)
        return (y if bias is None else y + bias.to(acc)).to(head.dtype)

    if head.tensor_axis is not None:
        return column_parallel(head, flat, compute)
    return compute(flat, head.weight, head.bias)


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

    def convs(self) -> list[TorchConv]:
        return [getattr(self, f"conv{i}") for i in range(self.n_layers + 1)] + [self.final]

    def out_rows(self, rows: Rows | None) -> Rows | None:
        return _out_rows(self.convs(), rows)

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, conv in enumerate(self.convs()[:-1]):
            x = conv(x, rows)
            rows = rows and rows.of(conv.out_height(rows.h))
            x = F.leaky_relu(x if i == 0 else instance_norm(x, rows=rows), 0.2)
        return self.final(x, rows)


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


class StridedPatchDiscriminator(nn.Module):
    """x: (N, H, W, in_channels) -> logits (N, h, w, 1): 4 x (conv(k4, s2, p1)
    with bias -> [instance norm, from the second block on] -> leaky_relu(0.2))
    at widths 64-128-256-512, then the head conv ``final`` to one feature.
    The head varies by family: ThermalGAN's pyramid discriminator (k3, p1,
    bias), its ``VAEDiscriminator2`` (k4, p1, no bias), its pix2pix
    ``DiscriminatorPix`` and CycleGAN's discriminator (k4, padding ((2, 1),
    (2, 1)): the reference's ZeroPad2d((1, 0, 1, 0)) + conv(p1); no bias and
    bias)."""

    def __init__(self, in_channels: int = 3, head_kernel: int = 4,
                 head_padding=((1, 1), (1, 1)), head_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        cin = in_channels
        for i, feats in enumerate(WIDTHS):
            setattr(self, f"conv{i}", TorchConv(cin, feats, stride=2, **kw))
            cin = feats
        self.final = TorchConv(cin, 1, kernel_size=head_kernel, padding=head_padding,
                               use_bias=head_bias, **kw)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Kernels normal(0, 0.02), biases zero, as the JAX ``TorchConv`` init."""
        init_normal_(self, generator)

    def convs(self) -> list[TorchConv]:
        return [getattr(self, f"conv{i}") for i in range(len(WIDTHS))] + [self.final]

    def out_rows(self, rows: Rows | None) -> Rows | None:
        return _out_rows(self.convs(), rows)

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, conv in enumerate(self.convs()[:-1]):
            x = conv(x, rows)
            rows = rows and rows.of(conv.out_height(rows.h))
            if i > 0:
                x = instance_norm(x, rows=rows)
            x = F.leaky_relu(x, 0.2)
        return self.final(x, rows)


class MultiDiscriminator(nn.Module):
    """ThermalGAN's pyramid: ``num_scales`` discriminators (``disc_0`` ...,
    each a ``StridedPatchDiscriminator`` with a k3 p1 biased head), the input
    average-pooled 2x (``ops.resize.avg_pool_2x``) between them. Returns the
    list of per-scale logit maps, scored by ``multiscale_loss``."""

    def __init__(self, in_channels: int = 3, num_scales: int = 3,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.num_scales = dtype, num_scales
        for i in range(num_scales):
            setattr(self, f"disc_{i}", StridedPatchDiscriminator(
                in_channels, head_kernel=3, head_padding=((1, 1), (1, 1)), dtype=dtype,
                device=device, generator=generator))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for i in range(self.num_scales):
            getattr(self, f"disc_{i}").reset_parameters(generator)

    def out_rows(self, rows: Rows | None) -> list[Rows | None]:
        """The records of the scales' logits for images of record ``rows``."""
        outs = []
        for i in range(self.num_scales):
            outs.append(getattr(self, f"disc_{i}").out_rows(rows))
            rows = rows and rows.of(avg_pool_height(rows.h))
        return outs

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> list[torch.Tensor]:
        outs = []
        x = x.to(self.dtype)
        for i in range(self.num_scales):
            outs.append(getattr(self, f"disc_{i}")(x, rows))
            if i + 1 < self.num_scales:
                x = avg_pool_2x(x, rows)
                rows = rows and rows.of(avg_pool_height(rows.h))
        return outs


def _out_rows(convs: list[TorchConv], rows: Rows | None) -> Rows | None:
    """The record of the logits of a stack of ``convs`` for images of record
    ``rows``."""
    if rows is None:
        return None
    h = rows.h
    for conv in convs:
        h = conv.out_height(h)
    return rows.of(h)


def multiscale_loss(outputs: list[torch.Tensor], target: float, loss: str = "l1",
                    rows: list[Rows | None] | None = None) -> torch.Tensor:
    """The mean over scales of each scale's mean L1 (``loss="l1"``, the
    reference's in-forward loss) or squared error against ``target``, in
    the outputs' dtype (no float32 cast, as in the JAX function). With
    ``rows`` (``MultiDiscriminator.out_rows``) this rank's share of it."""
    if loss not in ("l1", "mse"):
        raise ValueError(f"unknown multiscale loss {loss!r}")
    rows = rows or [None] * len(outputs)
    terms = [share_mean((out - target).abs() if loss == "l1" else (out - target).square(), r)
             for out, r in zip(outputs, rows)]
    return torch.stack(terms).mean()
