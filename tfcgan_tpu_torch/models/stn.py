"""The ViT-affine spatial transformer (the STN flagship's ``Net``), port of
``LocalizerViT``, ``AffineSTN`` and ``warp_src`` of ``tfcgan_tpu.models.stn``:
ViT over the (img_a, img_b) 6-channel concat -> the 17 x 768 tokens flattened ->
MLP 1024-512-256(sigmoid)-6 -> dtheta; theta = dtheta + identity; the source
is warped with bicubic/border sampling (align_corners=True).

``fast_warp=True`` (the default, as in the JAX package) warps with the
two-pass separable warp, whose passes are the hand-written resampling kernels
on a card (``ops/resample.py``); ``False`` takes the direct 2-D gather warp in
plain tensor code (``ops/warp.py``). The conv and deformable STNs come with
the NeMAR family.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tfcgan_tpu_torch.models.vit import Dense, ViT, lecun_normal_
from tfcgan_tpu_torch.ops.resample import warp_affine_separable
from tfcgan_tpu_torch.ops.warp import warp_affine

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
