"""ThermalGAN's two-stage models, port of ``tfcgan_tpu.models.thermalgan``.

Stage 1 (a cVAE-GAN): ``GeneratorG1``, a UNet-7 over cat(A, temperature
plane), 3x3 stride-2 convs down and nearest-2x upsample + 3x3 conv up;
``Encoder``, a ResNet trunk to (mu, logvar); the three-scale
``MultiDiscriminator`` lives in ``models.discriminator``. Stage 2 (pix2pix):
``GeneratorG2``, a UNet-8 of k4 s2 convs and transposed convs, fake_S ->
fake_B; ``DiscriminatorPix``, a stride-2 PatchGAN on (img, cond);
``VAEDiscriminator2``, ThermalGAN2's single stage-1 PatchGAN.

NHWC activations, float32 parameters cast to ``dtype`` by each layer.
Parameter names follow the JAX module tree (``down1.conv.weight`` <-
``down1/conv/kernel``, ``down2.bn.weight`` <- ``down2/bn/scale``), so
``bridge.conv_net_from_flax`` converts them; G2's up convs are transposed
convs (``bridge.thermalgan_generators_from_flax``). G2's nine dropout layers
(p = 0.5: downs 4-8, ups 1-4) take explicit keep-masks
(``GeneratorG2.draw_dropout_masks``); in training mode G2 refuses to run
without them.

Every model takes ``rows`` (the spatial mesh axis): it runs on this rank's
rows of its images (G1's temperature plane and G2's keep-masks come cut
to the rows), its convs fetch their halo rows, its instance and group norms
sum their statistics over the spatial group, and ``TrainBatchNorm`` its
moments over the data and spatial groups. A map with fewer rows than ranks
(G2's 1 x 1 innermost map at 256²) runs on the whole map. The Encoder's
max-pool and 8 x 8 mean run on rows (``parallel.spatial.window_op``), and
its last (N, 2, 2, 256) map is gathered once, so ``fc_mu`` and
``fc_logvar`` run whole on every rank. ``thermal_mask`` and
``normalized_temps`` sum their L2 norm along H over the group.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.models.discriminator import StridedPatchDiscriminator
from tfcgan_tpu_torch.models.layers import (GroupNorm, TorchConv, TorchConvTranspose,
                                             Upsample2xConv, _dropout, draws_on, init_normal_)
from tfcgan_tpu_torch.models.resnet import BasicBlock, flax_init_
from tfcgan_tpu_torch.models.vit import Dense
from tfcgan_tpu_torch.ops.norm import instance_norm
from tfcgan_tpu_torch.parallel.mesh import active_mesh, all_reduce_sum
from tfcgan_tpu_torch.parallel.spatial import Rows, gather_spatial, spatial_sum, window_op

_PAD1 = ((1, 1), (1, 1))


class TrainBatchNorm(nn.Module):
    """The reference's ``BatchNorm2d(out, 0.8)`` in train mode: the
    positional 0.8 lands on **eps**. Batch statistics always (the reference
    never runs the net in eval mode), the biased variance, in float32 (in
    float64 for a float64 input); no running statistics. ``weight`` and
    ``bias`` are the JAX ``scale`` and ``bias`` (init 1 + 0.02 N(0, 1) and 0). In a data-parallel step the
    moments are the global batch's, as GSPMD computes them in the JAX step
    (not DataParallel's per-card ones); on row shards (``rows``) over every
    row too: the sums go over the data and the spatial groups, and the
    count is the global batch x H x W."""

    def __init__(self, channels: int, eps: float = 0.8, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        mesh = active_mesh()
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        if mesh is None and rows is None:
            y = F.batch_norm(x.to(acc).permute(0, 3, 1, 2), None, None, self.weight.to(acc),
                             self.bias.to(acc), training=True, eps=self.eps)
            return y.permute(0, 2, 3, 1).to(x.dtype)
        # a data-parallel step: the global batch's moments, the mean and then
        # the centred (two-pass) variance, each summed over the ranks
        xf = x.to(acc)
        count = xf.shape[0] * (xf.shape[1] if rows is None else rows.h) * xf.shape[2]
        count *= 1 if mesh is None else mesh.data_size

        def total(t):
            return spatial_sum(all_reduce_sum(t.sum(dim=(0, 1, 2)), mesh), rows)

        mean = total(xf) / count
        var = total((xf - mean).square()) / count
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


class _DownBic(nn.Module):
    """conv(k3, s2, p1, no bias) -> [instance norm | TrainBatchNorm] -> leaky_relu(0.2)."""

    def __init__(self, cin: int, feats: int, normalize: bool, norm: str, dtype, device):
        super().__init__()
        self.normalize, self.norm = normalize, norm
        self.conv = TorchConv(cin, feats, kernel_size=3, stride=2, padding=_PAD1,
                              use_bias=False, dtype=dtype, device=device)
        self.bn = TrainBatchNorm(feats, device=device) if normalize and norm == "batch" else None

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        x = self.conv(x, rows)
        rows = rows and rows.of(self.conv.out_height(rows.h))
        if self.normalize:
            x = self.bn(x, rows) if self.bn is not None else instance_norm(x, rows=rows)
        return F.leaky_relu(x, 0.2)


class _UpBic(nn.Module):
    """nearest-2x + conv(k3, p1, no bias) -> norm -> leaky_relu(0.01) ->
    concat(skip) on channels."""

    def __init__(self, cin: int, feats: int, norm: str, dtype, device):
        super().__init__()
        self.conv = Upsample2xConv(cin, feats, kernel_size=3, padding=_PAD1, use_bias=False,
                                   dtype=dtype, device=device)
        self.bn = TrainBatchNorm(feats, device=device) if norm == "batch" else None

    def forward(self, x: torch.Tensor, skip: torch.Tensor, rows: Rows | None = None
                ) -> torch.Tensor:
        """With ``rows`` (``x``'s record) the skip is this rank's rows of a
        map of the upsampled height."""
        x = self.conv(x, rows)
        rows = rows and rows.of(self.conv.out_height(rows.h))
        x = self.bn(x, rows) if self.bn is not None else instance_norm(x, rows=rows)
        x = F.leaky_relu(x, 0.01)  # the reference's default LeakyReLU slope
        return torch.cat([x, skip.to(x.dtype)], dim=-1)


G1_DOWNS = (64, 128, 256, 512, 512, 512, 512)
G1_UPS = (512, 512, 512, 256, 128, 64)


class GeneratorG1(nn.Module):
    """(x (N, H, W, C), t (N, H, W)) -> (N, H, W, out_channels): the UNet-7
    over cat(x, t). ``norm="batch"`` is ThermalGAN2's variant: TrainBatchNorm
    blocks, down7 not normalized."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, norm: str = "instance",
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if norm not in ("instance", "batch"):
            raise ValueError(f"norm must be 'instance' or 'batch', got {norm!r}")
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        cin = in_channels + 1
        for i, f in enumerate(G1_DOWNS):
            normalize = i > 0 and not (i == 6 and norm == "batch")
            setattr(self, f"down{i + 1}", _DownBic(cin, f, normalize, norm, **kw))
            cin = f
        for i, f in enumerate(G1_UPS):
            setattr(self, f"up{i + 1}", _UpBic(cin, f, norm, **kw))
            cin = f + G1_DOWNS[-(i + 2)]
        self.final = Upsample2xConv(cin, out_channels, kernel_size=3, padding=_PAD1, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Conv kernels normal(0, 0.02), biases zero, the batch norms' scales
        1 + 0.02 N(0, 1), as the JAX init; drawn on the CPU from ``generator``."""
        if not draws_on():
            return
        init_normal_(self, generator)
        for m in self.modules():
            if isinstance(m, TrainBatchNorm):
                m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape, generator=generator))
                m.bias.zero_()

    def forward(self, x: torch.Tensor, t: torch.Tensor, rows: Rows | None = None
                ) -> torch.Tensor:
        """With ``rows``, ``x``, ``t`` and the result are this rank's rows."""
        h = torch.cat([x.to(self.dtype), t[..., None].to(self.dtype)], dim=-1)
        downs = []
        for i in range(len(G1_DOWNS)):
            down = getattr(self, f"down{i + 1}")
            h = down(h, rows)
            rows = rows and rows.of(down.conv.out_height(rows.h))
            downs.append((h, rows))
        u, rows = downs[-1]
        for i in range(len(G1_UPS)):
            u = getattr(self, f"up{i + 1}")(u, downs[-(i + 2)][0], rows)
            rows = downs[-(i + 2)][1]
        return torch.tanh(self.final(u, rows))


ENCODER_BLOCKS = ((64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1))


class Encoder(nn.Module):
    """(N, H, W, in_channels) -> (mu, logvar), each (N, latent_dim): conv 7x7
    stride 2 (no bias), GroupNorm with one channel a group (eps 1e-6), relu,
    max-pool 3x3 stride 2 over -inf padding, six ``BasicBlock``s (ResNet-18's
    first three stages), an 8x8 average pool, the map flattened in NHWC
    order, then the Dense layers ``fc_mu`` and ``fc_logvar``. The Dense
    layers' width depends on the image side (1024 at 256²)."""

    def __init__(self, in_channels: int = 3, image_size: int = 256, latent_dim: int = 8,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.stem = TorchConv(in_channels, 64, kernel_size=7, stride=2, padding=((3, 3), (3, 3)),
                              use_bias=False, **kw)
        self.stem_norm = GroupNorm(64, 64, 1e-6, **kw)
        cin = 64
        for i, (feats, stride) in enumerate(ENCODER_BLOCKS):
            setattr(self, f"block{i}", BasicBlock(cin, feats, stride, **kw))
            cin = feats
        side = -(-image_size // 16) // 8  # four halvings, then the 8x8 pool
        if side < 1:
            raise ValueError(f"Encoder needs an image of at least 128², got {image_size}")
        self.fc_mu = Dense(side * side * cin, latent_dim, **kw)
        self.fc_logvar = Dense(side * side * cin, latent_dim, **kw)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's init (lecun-normal kernels, zero biases, norm scales one)."""
        flax_init_(self, generator)

    def forward(self, x: torch.Tensor, rows: Rows | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """With ``rows``, ``x`` is this rank's rows; (mu, logvar) are whole,
        the same on every rank."""
        h = self.stem(x.to(self.dtype), rows)
        rows = rows and rows.of(self.stem.out_height(rows.h))
        h = F.relu(self.stem_norm(h, rows))
        h = window_op(h, rows, 3, 2, 1, _max_pool_3x3)
        rows = rows and rows.of((rows.h - 1) // 2 + 1)
        for i in range(len(ENCODER_BLOCKS)):
            block = getattr(self, f"block{i}")
            h = block(h, rows)
            rows = rows and rows.of(block.out_height(rows.h))
        h = window_op(h, rows, 8, 8, 0, _avg_pool_8x8)
        h = gather_spatial(h, rows and rows.of(rows.h // 8))
        h = h.reshape(h.shape[0], -1)  # NHWC order, as the JAX module flattens
        return self.fc_mu(h), self.fc_logvar(h)


def _max_pool_3x3(h: torch.Tensor) -> torch.Tensor:
    """3 x 3 stride-2 max-pool over -inf padding."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)


def _avg_pool_8x8(h: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(h.permute(0, 3, 1, 2), 8, stride=8).permute(0, 2, 3, 1)



class _DownPix(nn.Module):
    """conv(k4, s2, p1, no bias) -> [instance norm] -> leaky_relu(0.2) ->
    [dropout: times ``keep``]."""

    def __init__(self, cin: int, feats: int, normalize: bool, dropout: float, dtype, device):
        super().__init__()
        self.normalize, self.dropout = normalize, dropout
        self.conv = TorchConv(cin, feats, stride=2, use_bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None,
                rows: Rows | None = None) -> torch.Tensor:
        x = self.conv(x, rows)
        if self.normalize:
            x = instance_norm(x, rows=rows and rows.of(self.conv.out_height(rows.h)))
        return _dropout(F.leaky_relu(x, 0.2), keep)


class _UpPix(nn.Module):
    """convT(k4, s2, p1, no bias) -> instance norm -> relu -> [dropout] ->
    concat(skip)."""

    def __init__(self, cin: int, feats: int, dropout: float, dtype, device):
        super().__init__()
        self.dropout = dropout
        self.conv = TorchConvTranspose(cin, feats, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                keep: torch.Tensor | None = None, rows: Rows | None = None) -> torch.Tensor:
        out = rows and rows.of(self.conv.out_height(rows.h))
        x = _dropout(F.relu(instance_norm(self.conv(x, rows), rows=out)), keep)
        return torch.cat([x, skip.to(x.dtype)], dim=-1)


G2_DOWNS = ((64, False, 0.0), (128, True, 0.0), (256, True, 0.0), (512, True, 0.5),
            (512, True, 0.5), (512, True, 0.5), (512, True, 0.5), (512, False, 0.5))
G2_UPS = ((512, 0.5), (512, 0.5), (512, 0.5), (512, 0.5), (256, 0.0), (128, 0.0), (64, 0.0))


class GeneratorG2(nn.Module):
    """The pix2pix UNet-8, (N, H, W, in_channels) -> (N, H, W, out_channels);
    eight stride-2 downs, so it needs at least 256²."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        cin = in_channels
        for i, (f, norm, drop) in enumerate(G2_DOWNS):
            setattr(self, f"down{i + 1}", _DownPix(cin, f, norm, drop, **kw))
            cin = f
        for i, (f, drop) in enumerate(G2_UPS):
            setattr(self, f"up{i + 1}", _UpPix(cin, f, drop, **kw))
            cin = f + G2_DOWNS[-(i + 2)][0]
        self.final = Upsample2xConv(cin, out_channels, **kw)
        init_normal_(self, generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_normal_(self, generator)

    def dropout_shapes(self, n: int, h: int, w: int) -> dict[str, tuple[int, ...]]:
        """Shapes of the dropout layers' inputs for an (n, h, w, C) input."""
        shapes = {}
        for i, (f, _, drop) in enumerate(G2_DOWNS):
            if drop:
                shapes[f"down{i + 1}"] = (n, h >> (i + 1), w >> (i + 1), f)
        for i, (f, drop) in enumerate(G2_UPS):
            if drop:
                s = len(G2_DOWNS) - 1 - i
                shapes[f"up{i + 1}"] = (n, h >> s, w >> s, f)
        return shapes

    def draw_dropout_masks(self, n: int, h: int, w: int, generator: torch.Generator
                           ) -> dict[str, torch.Tensor]:
        """Keep-masks for one forward: Bernoulli(1 - p) on ``generator``'s
        device, scaled by 1/(1-p), in the compute dtype."""
        masks = {}
        for name, shape in self.dropout_shapes(n, h, w).items():
            keep = 1.0 - getattr(self, name).dropout
            u = torch.rand(shape, generator=generator, device=generator.device)
            masks[name] = ((u < keep) / keep).to(self.dtype)
        return masks

    def forward(self, x: torch.Tensor, dropout_masks: dict[str, torch.Tensor] | None = None,
                rows: Rows | None = None) -> torch.Tensor:
        """In training mode ``dropout_masks`` is required; in eval mode it must
        be None. With ``rows``, ``x``, the masks and the result are this
        rank's rows."""
        height = x.shape[1] if rows is None else rows.h
        if height < 256 or x.shape[2] < 256:
            raise ValueError(f"GeneratorG2 needs >=256^2 inputs (8 downsamples), got "
                             f"{height}x{x.shape[2]}")
        if self.training and dropout_masks is None:
            raise ValueError("GeneratorG2 in training mode needs dropout_masks "
                             "(draw_dropout_masks); use .eval() for no dropout")
        if not self.training and dropout_masks is not None:
            raise ValueError("dropout_masks given to a GeneratorG2 in eval mode")
        keep = dropout_masks or {}
        d = x.to(self.dtype)
        downs = []
        for i in range(len(G2_DOWNS)):
            down = getattr(self, f"down{i + 1}")
            d = down(d, keep.get(f"down{i + 1}"), rows)
            rows = rows and rows.of(down.conv.out_height(rows.h))
            downs.append((d, rows))
        u, rows = downs[-1]
        for i in range(len(G2_UPS)):
            u = getattr(self, f"up{i + 1}")(u, downs[-(i + 2)][0], keep.get(f"up{i + 1}"), rows)
            rows = downs[-(i + 2)][1]
        return torch.tanh(self.final(u, rows))


class VAEDiscriminator2(StridedPatchDiscriminator):
    """ThermalGAN2's stage-1 D: the pix2pix-style PatchGAN on the
    segmentation image alone, a k4 p1 head without bias, scored with MSE."""

    def __init__(self, in_channels: int = 3, **kw):
        super().__init__(in_channels, head_kernel=4, head_padding=_PAD1, head_bias=False, **kw)


class DiscriminatorPix(StridedPatchDiscriminator):
    """The pix2pix PatchGAN on cat(img, cond): k4 s2 blocks and the
    asymmetric-pad head without bias."""

    def __init__(self, in_channels: int = 6, **kw):
        super().__init__(in_channels, head_kernel=4, head_padding=((2, 1), (2, 1)),
                         head_bias=False, **kw)

    def forward(self, img: torch.Tensor, cond: torch.Tensor, rows: Rows | None = None
                ) -> torch.Tensor:
        return super().forward(torch.cat([img.to(self.dtype), cond.to(self.dtype)], dim=-1),
                               rows)


def thermal_mask(b: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
    """The segmentation surrogate: the inverted grayscale (channel mean) of
    the thermal image, L2-normalised along H (+1e-12), on 3 channels. With
    ``rows``, this rank's rows, the norm summed over the spatial group."""
    return normalized_temps(-b.mean(dim=-1), rows)[..., None].repeat(1, 1, 1, 3)


def normalized_temps(t: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
    """(N, H, W) temperatures L2-normalised along H (+1e-12); with ``rows``,
    this rank's rows, the column sums of squares summed over the group."""
    return t / (torch.sqrt(spatial_sum((t * t).sum(dim=1, keepdim=True), rows)) + 1e-12)
