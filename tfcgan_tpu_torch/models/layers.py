"""Layers with the reference's torch semantics on NHWC activations, port of
``tfcgan_tpu.models.layers``.

Activations between layers are NHWC-contiguous tensors (the memory of NCHW
``channels_last``); convolutions see ``x.permute(0, 3, 1, 2)`` views, so
cuDNN keeps that layout. Parameters are float32 in torch's own layouts (conv
``(out, in, kh, kw)``, transposed conv ``(in, out, kh, kw)``) and each layer
casts them to its compute dtype, as the JAX ``dtype`` field does.

Dropout takes its keep-masks as arguments (drawn by the recipe, already
scaled by 1/(1-p)), so one set of draws can be fed to the port and, rebuilt
from the same keys, held against the JAX package. ``SpectralConv`` keeps the
power-iteration vectors u and v as buffers, which
``spectral_power_iteration`` advances.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.ops.blurpool import blur_pool
from tfcgan_tpu_torch.ops.norm import instance_norm

Padding = tuple[tuple[int, int], tuple[int, int]]


def init_normal_(module: nn.Module, generator: torch.Generator | None = None,
                 std: float = 0.02) -> None:
    """The reference's ``weights_init_normal`` for the generator: every conv
    weight ~ normal(0, std), biases zero. Draws are made on the CPU from
    ``generator``, so one seed gives the same weights on every device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * std)


def _conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
               stride: int, padding: Padding, dtype: torch.dtype) -> torch.Tensor:
    (pt, pb), (pl, pr) = padding
    xc = x.to(dtype).permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad = (0, 0)
    w = weight.to(dtype).contiguous(memory_format=torch.channels_last)
    b = None if bias is None else bias.to(dtype)
    return F.conv2d(xc, w, b, stride=stride, padding=pad).permute(0, 2, 3, 1)


class TorchConv(nn.Module):
    """Conv2d with explicit, possibly asymmetric zero padding, NHWC."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 stride: int = 1, padding: Padding = ((1, 1), (1, 1)),
                 use_bias: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, kernel_size, kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(x, self.weight, self.bias, self.stride, self.padding, self.dtype)


class TorchConvTranspose(nn.Module):
    """ConvTranspose2d(k=4, s=2, p=1, no bias) on NHWC: H -> 2H."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(
            in_channels, features, kernel_size, kernel_size, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype).contiguous(memory_format=torch.channels_last)
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                               stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v), eps)


class SpectralConv(nn.Module):
    """Spectrally normalized conv(k4, s1, p1) with bias: the conv runs with
    W / sigma, sigma = u . (W v) differentiable through W only (u and v are
    buffers, advanced by ``spectral_power_iteration``). W is flattened as
    (out, in * kh * kw), torch's order; the bridge reorders v from flax's."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, 4, 4, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("u", torch.empty(features, device=device))
        self.register_buffer("v", torch.empty(in_channels * 16, device=device))

    def w_mat(self) -> torch.Tensor:
        return self.weight.reshape(self.weight.shape[0], -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sigma = torch.dot(self.u, torch.mv(self.w_mat(), self.v))
        return _conv_nhwc(x, self.weight / sigma, self.bias, 1, ((1, 1), (1, 1)), self.dtype)


@torch.no_grad()
def spectral_power_iteration(module: nn.Module, order: str = "vu") -> None:
    """One power iteration for every ``SpectralConv`` in ``module``.

    ``"vu"``: v <- normalize(W^T u); u <- normalize(W v), the per-step
    cadence's order. ``"uv"``: u <- normalize(W v); v <- normalize(W^T u),
    what torch's parametrizations.spectral_norm runs before each forward (the
    per-forward cadence). New tensors replace the buffers rather than being
    written in place: a forward earlier in the same step may have saved the
    old u and v for its backward."""
    if order not in ("vu", "uv"):
        raise ValueError(f"order must be 'vu' or 'uv', got {order!r}")
    for m in module.modules():
        if isinstance(m, SpectralConv):
            w = m.w_mat()
            if order == "uv":
                m.u = _l2_normalize(torch.mv(w, m.v))
                m.v = _l2_normalize(torch.mv(w.t(), m.u))
            else:
                m.v = _l2_normalize(torch.mv(w.t(), m.u))
                m.u = _l2_normalize(torch.mv(w, m.v))


def _dropout(x: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
    """x times a keep-mask of x's shape holding 0 or 1/(1-p)."""
    return x if keep is None else x * keep.to(x.dtype)


class UNetDown(nn.Module):
    """conv(k4, s1, p1, no bias) -> [instance norm] -> leaky_relu(0.2) ->
    blur_pool(stride 2) -> [dropout: times ``keep``, when given]."""

    def __init__(self, in_channels: int, features: int, normalize: bool = True,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.normalize, self.dropout = normalize, dropout
        self.conv = TorchConv(in_channels, features, use_bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        x = self.conv(x)
        if self.normalize:
            x = instance_norm(x)
        x = F.leaky_relu(x, 0.2)
        return _dropout(blur_pool(x, stride=2), keep)


class UNetUp(nn.Module):
    """convT(k4, s2, p1, no bias) -> blur_pool(stride 1) -> instance norm ->
    relu -> [dropout: times ``keep``, when given] -> concat(skip) on channels."""

    def __init__(self, in_channels: int, features: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dropout = dropout
        self.conv = TorchConvTranspose(in_channels, features, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        x = blur_pool(self.conv(x), stride=1)
        x = _dropout(F.relu(instance_norm(x)), keep)
        return torch.cat([x, skip.to(x.dtype)], dim=-1)


class Upsample2xConv(nn.Module):
    """Nearest-2× upsample, zero pad, conv(k): the generator head. The pad is
    the post-upsample one (``((2, 1), (2, 1))`` for the reference's
    ZeroPad2d((1,0,1,0)) + Conv(k4, p1)); the parameter is one conv kernel
    plus bias, as in the JAX module."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 padding: Padding = ((2, 1), (2, 1)), use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, kernel_size, kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = F.interpolate(x.to(self.dtype).permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return _conv_nhwc(up.permute(0, 2, 3, 1), self.weight, self.bias, 1, self.padding,
                          self.dtype)
