"""Spatial transformers, port of ``tfcgan_tpu.models.stn``: the ViT-affine STN
of the STN flagship and NeMAR's conv-affine and deformable STNs.

``LocalizerViT``, ``AffineSTN`` and ``warp_src`` (the flagship's ``Net``): ViT
over the (img_a, img_b) 6-channel concat -> the 17 x 768 tokens flattened ->
MLP 1024-512-256(sigmoid)-6 -> dtheta; theta = dtheta + identity; the source
is warped with bicubic/border sampling (align_corners=True).

``fast_warp=True`` (the default, as in the JAX package) warps with the
two-pass separable warp, whose passes are the hand-written resampling kernels
on a card (``ops/resample.py``); ``False`` takes the direct 2-D gather warp in
plain tensor code (``ops/warp.py``).

``CNNAffineSTN`` (NeMAR's AffineNetwork): 5 x (conv3 -> instance norm -> relu
-> 2x2 max-pool) -> Dense -> relu -> Dense(6, near-zero init) = dtheta; each
target is warped by theta = identity + dtheta with bilinear/zeros sampling
(align_corners=False); the regulariser is mean |dtheta|.

``DeformableSTN`` (NeMAR's UnetSTN): a ResUnet (7 conv + max-pool stages, a
1x1 bottleneck with 3 residual blocks, 7 bilinear-upsample + skip-concat +
conv stages, a refine block) predicts a 2-channel offset field, zero at init,
that is added to the identity grid; all targets are warped by that grid in
**one** sampling call on their channel concat; the regulariser is the
(bilateral) total variation of the offsets, ``smoothness_loss``. With
``fast_warp=True`` (the default) the sampling is ``grid_sample_dense``: the
hand-written kernels on a card (``ops/gridsample.py``), the plain version on
the CPU; ``False`` takes ``ops/warp.grid_sample`` in plain tensor code.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.models.layers import TorchConv, init_normal_
from tfcgan_tpu_torch.models.vit import Dense, ViT, lecun_normal_
from tfcgan_tpu_torch.ops.gridsample import grid_sample_dense
from tfcgan_tpu_torch.ops.norm import instance_norm
from tfcgan_tpu_torch.ops.pooling import pool22
from tfcgan_tpu_torch.ops.resample import warp_affine_separable
from tfcgan_tpu_torch.ops.warp import affine_grid, grid_sample, warp_affine

IDENTITY_THETA = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


class LocalizerViT(ViT):
    """The flagship's localizer: ViT-Base with patch 64 over 6 channels."""

    def __init__(self, image_size: int, dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(image_size, in_channels=6, patch_size=64, dtype=dtype, device=device,
                         generator=generator)


def warp_src(src: torch.Tensor, theta: torch.Tensor, *, mode: str, padding_mode: str,
             fast: bool) -> torch.Tensor:
    """The STN's warp of ``src`` (N, H, W, C) by ``theta`` (N, 2, 3): the
    separable warp when ``fast``, else the direct align_corners=True gather
    warp; the result has ``src``'s dtype."""
    if fast:
        return warp_affine_separable(src, theta, mode=mode, padding_mode=padding_mode)
    return warp_affine(src, theta, mode=mode, padding_mode=padding_mode,
                       align_corners=True).to(src.dtype)


class AffineSTN(nn.Module):
    """Predicts theta from (img_a, img_b) and warps ``src`` with it.

    ``identity_init=True`` zero-initializes the dtheta head ``fc4``, so theta
    starts at the exact identity; ``False`` gives it the default Dense init.
    ``vit`` overrides the localizer's ViT arguments (``patch_size``, ``dim``,
    ``depth``, ``heads``, ``mlp_dim``); the default is ``LocalizerViT``."""

    def __init__(self, image_size: int, dtype: torch.dtype = torch.float32,
                 mode: str = "bicubic", padding_mode: str = "border", fast_warp: bool = True,
                 identity_init: bool = True, vit: dict | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.mode, self.padding_mode = dtype, mode, padding_mode
        self.fast_warp, self.identity_init = fast_warp, identity_init
        kw = dict(dtype=dtype, device=device)
        if vit is None:
            self.vit = LocalizerViT(image_size, generator=generator, **kw)
        else:
            self.vit = ViT(image_size, in_channels=6, generator=generator, **vit, **kw)
        self.fc1 = Dense(self.vit.tokens * self.vit.dim, 1024, **kw)
        self.fc2 = Dense(1024, 512, **kw)
        self.fc3 = Dense(512, 256, **kw)
        self.fc4 = Dense(256, 6, **kw)
        self.register_buffer("identity", torch.tensor(IDENTITY_THETA, device=device),
                             persistent=False)
        self._reset_head(generator)  # the ViT drew its own weights above

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's init for the ViT and the MLP, drawn on the CPU from
        ``generator``; ``fc4`` zero under ``identity_init``."""
        self.vit.reset_parameters(generator)
        self._reset_head(generator)

    @torch.no_grad()
    def _reset_head(self, generator: torch.Generator | None) -> None:
        for fc in (self.fc1, self.fc2, self.fc3, self.fc4):
            lecun_normal_(fc, generator)
        if self.identity_init:
            self.fc4.weight.zero_()
            self.fc4.bias.zero_()

    def theta(self, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
        """(N, 2, 3) float32."""
        tokens = self.vit(torch.cat([img_a.to(self.dtype), img_b.to(self.dtype)], dim=-1))
        h = torch.relu(self.fc1(tokens.flatten(1)))
        h = torch.relu(self.fc2(h))
        h = torch.sigmoid(self.fc3(h))
        return (self.fc4(h).float() + self.identity).reshape(-1, 2, 3)

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor, src: torch.Tensor
                ) -> torch.Tensor:
        return warp_src(src, self.theta(img_a, img_b), mode=self.mode,
                        padding_mode=self.padding_mode, fast=self.fast_warp)


# ------------------------------------------------------------ NeMAR's STNs
_PAD1 = ((1, 1), (1, 1))
_NO_PAD = ((0, 0), (0, 0))


def _dense_warp(img: torch.Tensor, grid: torch.Tensor, fast: bool) -> torch.Tensor:
    """Bilinear/zeros/align_corners=False sample of ``img`` (N, H, W, C) at
    ``grid``: ``grid_sample_dense`` when ``fast``, else the plain tensor code;
    the result has ``img``'s dtype."""
    if fast:
        return grid_sample_dense(img, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)
    return grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                       align_corners=False).to(img.dtype)


def _identity_grid(n: int, h: int, w: int, device) -> torch.Tensor:
    theta = torch.tensor(IDENTITY_THETA, device=device).reshape(1, 2, 3).expand(n, 2, 3)
    return affine_grid(theta, (n, h, w), align_corners=False)


class CNNAffineSTN(nn.Module):
    """(img_a, img_b, apply_on) -> (the warped targets, mean |dtheta|). The
    first Dense reads the last feature map flattened in NHWC order, as the JAX
    module does, so it is sized for one ``image_size``."""

    def __init__(self, image_size: int, in_channels: int = 6, nconvs: int = 5, nf0: int = 32,
                 max_nf: int = 256, dtype: torch.dtype = torch.float32, fast_warp: bool = True,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.nconvs, self.fast_warp = dtype, nconvs, fast_warp
        kw = dict(dtype=dtype, device=device)
        cin, nf = in_channels, nf0
        for i in range(nconvs):
            setattr(self, f"conv{i}", TorchConv(cin, nf, kernel_size=3, padding=_PAD1, **kw))
            cin, nf = nf, min(2 * nf, max_nf)
        side = image_size // 2**nconvs
        self.fc1 = Dense(side * side * cin, nf, **kw)
        self.fc2 = Dense(nf, 6, **kw)
        self.register_buffer("identity", torch.tensor(IDENTITY_THETA, device=device),
                             persistent=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Conv kernels normal(0, 0.02), ``fc1`` flax's default, ``fc2``
        normal(0, 5e-4): theta starts next to the identity. Biases zero."""
        init_normal_(self, generator)
        lecun_normal_(self.fc1, generator)
        self.fc2.weight.copy_(torch.randn(self.fc2.weight.shape, generator=generator) * 5e-4)

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor,
                apply_on: list[torch.Tensor] | None = None
                ) -> tuple[list[torch.Tensor], torch.Tensor]:
        x = torch.cat([img_a.to(self.dtype), img_b.to(self.dtype)], dim=-1)
        for i in range(self.nconvs):
            x = pool22(F.relu(instance_norm(getattr(self, f"conv{i}")(x))))
        h = F.relu(self.fc1(x.reshape(x.shape[0], -1)))
        dtheta = self.fc2(h).float()
        theta = (dtheta + self.identity).reshape(-1, 2, 3)
        warped = []
        for img in [img_a] if apply_on is None else apply_on:
            n, hh, ww, _ = img.shape
            grid = affine_grid(theta, (n, hh, ww), align_corners=False)
            warped.append(_dense_warp(img, grid, self.fast_warp))
        return warped, dtheta.abs().mean()


class _ResBlock(nn.Module):
    """x + conv3(relu(conv3(x)))."""

    def __init__(self, feats: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(kernel_size=3, padding=_PAD1, dtype=dtype, device=device)
        self.c1 = TorchConv(feats, feats, **kw)
        self.c2 = TorchConv(feats, feats, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c2(F.relu(self.c1(x)))


def _upsample_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Bilinear resize (half-pixel centres) of NHWC ``x`` to ``like``'s H and W."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=like.shape[1:3], mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


class DeformableSTN(nn.Module):
    """(img_a, img_b, apply_on) -> (the warped targets, the smoothness term of
    the offset field, weighted by ``img_b``'s edges when ``alpha`` > 0)."""

    def __init__(self, in_channels: int = 6, down_nf=(32, 64, 64, 64, 64, 64, 64),
                 up_nf=(64, 64, 64, 64, 64, 64, 32), res_blocks: int = 3, alpha: float = 0.0,
                 dtype: torch.dtype = torch.float32, fast_warp: bool = True, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.alpha, self.fast_warp = dtype, alpha, fast_warp
        self.n_down, self.n_up, self.res_blocks = len(down_nf), len(up_nf), res_blocks
        kw = dict(dtype=dtype, device=device)
        cin = in_channels
        for i, nf in enumerate(down_nf):
            setattr(self, f"down{i}", TorchConv(cin, nf, kernel_size=3, padding=_PAD1, **kw))
            cin = nf
        nf = down_nf[-1]
        self.c1 = TorchConv(nf, 2 * nf, kernel_size=1, padding=_NO_PAD, **kw)
        for i in range(res_blocks):
            setattr(self, f"res{i}", _ResBlock(2 * nf, **kw))
        self.c2 = TorchConv(2 * nf, nf, kernel_size=1, padding=_NO_PAD, **kw)
        cin = nf
        for i, nf_up in enumerate(up_nf):  # each reads concat(upsampled x, skip)
            setattr(self, f"up{i}", TorchConv(cin + down_nf[-(i + 1)], nf_up, kernel_size=3,
                                              padding=_PAD1, **kw))
            cin = nf_up
        self.refine_res = _ResBlock(cin, **kw)
        self.refine_conv = TorchConv(cin, cin, kernel_size=1, padding=_NO_PAD, **kw)
        self.offset = TorchConv(cin, 2, kernel_size=3, padding=_PAD1, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Kernels normal(0, 0.02), biases zero; the offset head zero, so the
        warp starts at the identity."""
        init_normal_(self, generator)
        self.offset.weight.zero_()

    def offsets(self, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
        """The offset field (N, H, W, 2), float32, in normalized (x, y) units."""
        x = torch.cat([img_a.to(self.dtype), img_b.to(self.dtype)], dim=-1)
        skips = []
        for i in range(self.n_down):
            x = F.leaky_relu(getattr(self, f"down{i}")(x), 0.2)
            skips.append(x)
            x = pool22(x)
        x = F.leaky_relu(self.c1(x), 0.2)
        for i in range(self.res_blocks):
            x = getattr(self, f"res{i}")(x)
        x = F.leaky_relu(self.c2(x), 0.2)
        for i in range(self.n_up):
            skip = skips[-(i + 1)]
            x = torch.cat([_upsample_to(x, skip), skip], dim=-1)
            x = F.leaky_relu(getattr(self, f"up{i}")(x), 0.2)
        x = F.leaky_relu(self.refine_conv(self.refine_res(x)), 0.2)
        return self.offset(x).float()

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor,
                apply_on: list[torch.Tensor] | None = None
                ) -> tuple[list[torch.Tensor], torch.Tensor]:
        offset = self.offsets(img_a, img_b)
        n, hh, ww, _ = offset.shape
        grid = _identity_grid(n, hh, ww, offset.device) + offset
        targets = [img_a] if apply_on is None else apply_on
        # one sampling call for all targets: they share the grid
        stacked = torch.cat([img.float() for img in targets], dim=-1)
        wall = _dense_warp(stacked, grid, self.fast_warp)
        warped, c0 = [], 0
        for img in targets:
            c1 = c0 + img.shape[-1]
            warped.append(wall[..., c0:c1].to(img.dtype))
            c0 = c1
        return warped, smoothness_loss(offset, img_b, alpha=self.alpha)


def smoothness_loss(offset: torch.Tensor, img: torch.Tensor, alpha: float = 0.0) -> torch.Tensor:
    """Mean absolute difference of neighbouring offsets along H plus along W;
    with ``alpha`` > 0 each difference is weighted by exp(-alpha * |d img|),
    the image difference averaged over channels. offset: (N, H, W, 2); img:
    (N, H, W, C)."""
    dy = torch.diff(offset, dim=1).abs()
    dx = torch.diff(offset, dim=2).abs()
    if alpha > 0:
        dy = dy * torch.exp(-alpha * torch.diff(img, dim=1).abs().mean(dim=-1, keepdim=True))
        dx = dx * torch.exp(-alpha * torch.diff(img, dim=2).abs().mean(dim=-1, keepdim=True))
    return dy.mean() + dx.mean()
