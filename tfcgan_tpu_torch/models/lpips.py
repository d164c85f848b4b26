"""LPIPS perceptual distance on a VGG16 tower, port of ``tfcgan_tpu.models.lpips``.

(x, y) in [-1, 1] -> shift/scale with the published constants -> VGG16
features after conv 2/4/7/10/13 (post-ReLU) -> unit-normalize over channels
in float32 -> squared difference weighted by |lin| -> spatial mean -> sum
over the 5 taps. The parameters are frozen; the real-image tower runs under
``torch.no_grad``. Parameter names follow the flax tree (``vgg.conv1.weight``
<- ``vgg/conv1/kernel``, ``lin0`` <- ``lin0``).

Pretrained weights are not in the repository, so fft_glo trains with random
ones, as the JAX package does without weights: lecun-normal convs with zero
biases and uniform(0, 0.1) lin weights. Where the JAX package would load
converted weights (``lpips_weights``, ``$TFCGAN_LPIPS_WEIGHTS`` or
``weights/lpips_flax.msgpack``), the port refuses to run instead of training
on random ones.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn as nn

from tfcgan_tpu_torch.models.layers import TorchConv
from tfcgan_tpu_torch.ops.pooling import pool22

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
_TAPS = {2, 4, 7, 10, 13}
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
_WEIGHTS_ENV = "TFCGAN_LPIPS_WEIGHTS"
_WEIGHTS_NAME = "lpips_flax.msgpack"


class VGG16Features(nn.Module):
    """The VGG16 conv tower (3x3 convs, pad 1, bias, ReLU; 2x2 max-pools),
    returning the 5 LPIPS taps."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        cin, idx = 3, 0
        for item in _VGG_CFG:
            if item == "M":
                continue
            idx += 1
            setattr(self, f"conv{idx}", TorchConv(cin, item, kernel_size=3, dtype=dtype,
                                                  device=device))
            cin = item

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats, idx = [], 0
        h = x.to(self.dtype)
        for item in _VGG_CFG:
            if item == "M":
                h = pool22(h)
                continue
            idx += 1
            h = torch.relu(getattr(self, f"conv{idx}")(h))
            if idx in _TAPS:
                feats.append(h)
        return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt((f * f).sum(dim=-1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """d(x, y) for NHWC x, y in [-1, 1] -> (N,) distances; gradients flow to
    x only."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.vgg = VGG16Features(dtype=dtype, device=device)
        for i, c in enumerate(LPIPS_CHANNELS):
            setattr(self, f"lin{i}", nn.Parameter(torch.empty(c, device=device)))
        self.register_buffer("shift", torch.tensor(_SHIFT, device=device), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=device), persistent=False)
        self.reset_parameters(generator)
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX init's distributions, drawn on the CPU from ``generator``:
        lecun-normal conv kernels (truncated at 2 std, fan-in 9 * C_in), zero
        biases, lin weights uniform(0, 0.1)."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.startswith("lin"):
                p.copy_(torch.rand(p.shape, generator=generator) * 0.1)
            else:
                # jax.nn.initializers.lecun_normal: truncated normal rescaled
                # so that its std is sqrt(1 / fan_in)
                std = math.sqrt(1.0 / p[0].numel()) / 0.87962566103423978
                w = torch.empty(p.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                p.copy_(w)

    def _scaled(self, x: torch.Tensor) -> torch.Tensor:
        return ((x.float() - self.shift) / self.scale).to(self.dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.vgg(self._scaled(x))
        with torch.no_grad():
            fy = self.vgg(self._scaled(y))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_unit_normalize(a.float()) - _unit_normalize(b.float())).square()
            w = getattr(self, f"lin{i}").abs()
            total = total + (d * w).sum(dim=-1).mean(dim=(1, 2))
        return total


def default_weights_path() -> str:
    """``$TFCGAN_LPIPS_WEIGHTS`` if set, else ``weights/lpips_flax.msgpack``
    beside the package if it exists, else ""."""
    env = os.environ.get(_WEIGHTS_ENV, "")
    if env:
        return env
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cand = os.path.join(here, "weights", _WEIGHTS_NAME)
    return cand if os.path.exists(cand) else ""


def resolve_lpips_weights(loss_cfg) -> str:
    """``LossConfig.lpips_weights`` if set, else ``default_weights_path()``."""
    return getattr(loss_cfg, "lpips_weights", "") or default_weights_path()


def resolve_perceptual(loss_cfg) -> str:
    """``LossConfig.perceptual``, with "auto" -> "lpips" iff weights exist,
    else "msrecon" (as the JAX package)."""
    mode = getattr(loss_cfg, "perceptual", "lpips")
    if mode != "auto":
        return mode
    path = resolve_lpips_weights(loss_cfg)
    return "lpips" if (path and os.path.exists(path)) else "msrecon"
