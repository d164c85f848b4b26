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

On a tensor mesh (``parallel.tensor``) a conv whose weight is sharded
computes only its out-channels and gathers them (``column_parallel``); its
``features`` stays the full count.

On a spatial mesh (``parallel.spatial``) the convs, the U-Net blocks and the
blur-pool take ``rows``, the ``Rows`` record of their input: the input is
this rank's row shard of a map of ``rows.h`` rows, and so is the output, of
the height ``out_height`` gives. Each conv fetches its halo rows first
(``row_op``) and then runs as above, column-parallel on a tensor mesh too;
the instance norms sum their statistics over the spatial group, and the
dropout keep-masks come cut to the block's rows (``parallel.shard_draws``);
``GroupNorm`` sums its group statistics over the spatial group as well.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfcgan_tpu_torch.ops.blurpool import blur_pool
from tfcgan_tpu_torch.ops.kernels.blurpool import out_len
from tfcgan_tpu_torch.ops.norm import group_norm, instance_norm
from tfcgan_tpu_torch.parallel.spatial import Rows, row_op
from tfcgan_tpu_torch.parallel.tensor import column_parallel, gather_dim, tensor_sum

Padding = tuple[tuple[int, int], tuple[int, int]]


_DRAWS_ON = True


@contextlib.contextmanager
def without_draws():
    """Modules built inside draw no weights: their parameters are allocated
    and left for ``recipe.init`` (``Trainer.init_state``), a checkpoint or
    the bridge to fill. Every weight-drawing init of the port
    (``init_normal_``, ``vit.lecun_normal_``, the ``reset_parameters`` of
    the discriminators, LPIPS and ResNet-18) returns at once while it holds."""
    global _DRAWS_ON
    before, _DRAWS_ON = _DRAWS_ON, False
    try:
        yield
    finally:
        _DRAWS_ON = before


def draws_on() -> bool:
    """False inside ``without_draws``."""
    return _DRAWS_ON


def init_normal_(module: nn.Module, generator: torch.Generator | None = None,
                 std: float = 0.02) -> None:
    """The reference's ``weights_init_normal`` for the generator: every conv
    weight ~ normal(0, std), biases zero. Draws are made on the CPU from
    ``generator``, so one seed gives the same weights on every device."""
    if not _DRAWS_ON:
        return
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


def sharded(rows: Rows | None) -> bool:
    """Whether ``rows`` names a row shard over more than one rank."""
    return rows is not None and rows.axis.size > 1


def _conv_rows(x: torch.Tensor, rows: Rows, k: int, stride: int, padding: Padding, run
               ) -> torch.Tensor:
    """A conv (kernel ``k``, ``stride``, ``padding``) on row shards:
    ``run(xw, cols)`` convolves the fetched, edge-padded rows ``xw`` with no
    row padding and the column padding ``cols``."""
    (pt, pb), cols = padding
    h_out = (rows.h + pt + pb - k) // stride + 1
    return row_op(x, rows, h_out, lambda lo, hi: (stride * lo - pt, stride * (hi - 1) - pt + k),
                  lambda xw, a, b, lo, hi: run(xw, ((0, 0), cols)))


class TorchConv(nn.Module):
    """Conv2d with explicit, possibly asymmetric zero padding, NHWC."""

    tensor_dims = {"weight": 0}  # the flax kernel's out-channels
    tensor_axis = None

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 stride: int = 1, padding: Padding = ((1, 1), (1, 1)),
                 use_bias: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.stride, self.padding, self.dtype, self.features = stride, padding, dtype, features
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, kernel_size, kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def _run(self, x: torch.Tensor, padding: Padding) -> torch.Tensor:
        def conv(x, weight, bias):
            return _conv_nhwc(x, weight, bias, self.stride, padding, self.dtype)

        if self.tensor_axis is not None:
            return column_parallel(self, x, conv)
        return conv(x, self.weight, self.bias)

    def out_height(self, h: int) -> int:
        (pt, pb), _ = self.padding
        return (h + pt + pb - self.weight.shape[2]) // self.stride + 1

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        if not sharded(rows):
            return self._run(x, self.padding)
        return _conv_rows(x, rows, self.weight.shape[2], self.stride, self.padding, self._run)


class TorchConvTranspose(nn.Module):
    """ConvTranspose2d(k=4, s=2, p=1, no bias) on NHWC: H -> 2H."""

    tensor_dims = {"weight": 1}  # (in, out, kh, kw)
    tensor_axis = None

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.stride, self.padding, self.dtype, self.features = stride, padding, dtype, features
        self.weight = nn.Parameter(torch.empty(
            in_channels, features, kernel_size, kernel_size, device=device))

    def _conv(self, x: torch.Tensor, weight: torch.Tensor, bias=None,
              row_padding: int | None = None) -> torch.Tensor:
        w = weight.to(self.dtype).contiguous(memory_format=torch.channels_last)
        rp = self.padding if row_padding is None else row_padding
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2), w, stride=self.stride,
                               padding=(rp, self.padding))
        return y.permute(0, 2, 3, 1)

    def _run(self, x: torch.Tensor, row_padding: int | None = None) -> torch.Tensor:
        conv = functools.partial(self._conv, row_padding=row_padding)
        if self.tensor_axis is not None:
            return column_parallel(self, x, conv)
        return conv(x, self.weight)

    def out_height(self, h: int) -> int:
        return (h - 1) * self.stride - 2 * self.padding + self.weight.shape[2]

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        if not sharded(rows):
            return self._run(x)
        k, s, p = self.weight.shape[2], self.stride, self.padding

        def need(lo, hi):  # input i feeds outputs [s i - p, s i - p + k)
            return -((k - 1 - lo - p) // s), (hi - 1 + p) // s + 1

        def compute(xw, a, b, lo, hi):  # unpadded, window row o' is global o' - p + s a
            return self._run(xw, 0)[:, lo + p - s * a:hi + p - s * a]

        return row_op(x, rows, self.out_height(rows.h), need, compute, edge="clip")


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v), eps)


class SpectralConv(nn.Module):
    """Spectrally normalized conv(k4, s1, p1) with bias: the conv runs with
    W / sigma, sigma = u . (W v) differentiable through W only (u and v are
    buffers, advanced by ``spectral_power_iteration``). W is flattened as
    (out, in * kh * kw), torch's order; the bridge reorders v from flax's.
    With W sharded, sigma is the tensor group's sum of the partial products
    u_r . (W_r v), whose backward sums the ranks' partial gradients of sigma."""

    tensor_dims = {"weight": 0}
    tensor_axis = None

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype, self.features = dtype, features
        self.weight = nn.Parameter(torch.empty(features, in_channels, 4, 4, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("u", torch.empty(features, device=device))
        self.register_buffer("v", torch.empty(in_channels * 16, device=device))

    def w_mat(self) -> torch.Tensor:
        return self.weight.reshape(self.weight.shape[0], -1)

    def full_w_mat(self) -> torch.Tensor:
        """W as (out, in * kh * kw), gathered where it is sharded (no autograd)."""
        if self.tensor_axis is None:
            return self.w_mat()
        return gather_dim(self.w_mat().detach(), 0, self.tensor_axis)

    def out_height(self, h: int) -> int:
        return h - 1

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        """On row shards sigma comes from the replicated W, u and v: nothing
        of it is sharded."""
        axis = self.tensor_axis
        if axis is None:
            sigma = torch.dot(self.u, torch.mv(self.w_mat(), self.v))
        else:
            n = self.weight.shape[0]
            sigma = tensor_sum(torch.dot(self.u[axis.rank * n:(axis.rank + 1) * n],
                                         torch.mv(self.w_mat(), self.v)), axis)

        def run(x, padding):
            def conv(x, w, b):
                return _conv_nhwc(x, w / sigma, b, 1, padding, self.dtype)

            if axis is None:
                return conv(x, self.weight, self.bias)
            return column_parallel(self, x, conv)

        if not sharded(rows):
            return run(x, ((1, 1), (1, 1)))
        return _conv_rows(x, rows, 4, 1, ((1, 1), (1, 1)), run)


@torch.no_grad()
def spectral_power_iteration(module: nn.Module, order: str = "vu") -> None:
    """One power iteration for every ``SpectralConv`` in ``module``.

    ``"vu"``: v <- normalize(W^T u); u <- normalize(W v), the per-step
    cadence's order. ``"uv"``: u <- normalize(W v); v <- normalize(W^T u),
    what torch's parametrizations.spectral_norm runs before each forward (the
    per-forward cadence). New tensors replace the buffers rather than being
    written in place: a forward earlier in the same step may have saved the
    old u and v for its backward. A sharded W is gathered first, so that u
    and v stay equal on every rank of the tensor group."""
    if order not in ("vu", "uv"):
        raise ValueError(f"order must be 'vu' or 'uv', got {order!r}")
    for m in module.modules():
        if isinstance(m, SpectralConv):
            w = m.full_w_mat()
            if order == "uv":
                m.u = _l2_normalize(torch.mv(w, m.v))
                m.v = _l2_normalize(torch.mv(w.t(), m.u))
            else:
                m.v = _l2_normalize(torch.mv(w.t(), m.u))
                m.u = _l2_normalize(torch.mv(w, m.v))


class GroupNorm(nn.Module):
    """Flax ``GroupNorm(num_groups, epsilon, dtype)`` on NHWC: float32
    statistics, the result in ``dtype``; with ``rows`` on row shards, the
    statistics summed over the spatial group."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.groups, self.eps, self.dtype = groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        return group_norm(x, self.groups, self.weight, self.bias, self.eps, rows).to(self.dtype)


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

    @staticmethod
    def out_height(h: int) -> int:
        return out_len(h - 1, 2)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None,
                rows: Rows | None = None) -> torch.Tensor:
        x = self.conv(x, rows)
        rows = rows and rows.of(self.conv.out_height(rows.h))
        if self.normalize:
            x = instance_norm(x, rows=rows)
        x = F.leaky_relu(x, 0.2)
        return _dropout(blur_pool(x, 2, rows), keep)


class UNetUp(nn.Module):
    """convT(k4, s2, p1, no bias) -> blur_pool(stride 1) -> instance norm ->
    relu -> [dropout: times ``keep``, when given] -> concat(skip) on channels.
    On row shards the skip has the upsampled map's height and partition."""

    def __init__(self, in_channels: int, features: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dropout = dropout
        self.conv = TorchConvTranspose(in_channels, features, dtype=dtype, device=device)

    @staticmethod
    def out_height(h: int) -> int:
        return 2 * h

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                keep: torch.Tensor | None = None, rows: Rows | None = None) -> torch.Tensor:
        x = self.conv(x, rows)
        rows = rows and rows.of(self.out_height(rows.h))
        x = blur_pool(x, 1, rows)
        x = _dropout(F.relu(instance_norm(x, rows=rows)), keep)
        return torch.cat([x, skip.to(x.dtype)], dim=-1)


class Upsample2xConv(nn.Module):
    """Nearest-2× upsample, zero pad, conv(k): the generator head. The pad is
    the post-upsample one (``((2, 1), (2, 1))`` for the reference's
    ZeroPad2d((1,0,1,0)) + Conv(k4, p1)); the parameter is one conv kernel
    plus bias, as in the JAX module."""

    tensor_dims = {"weight": 0}
    tensor_axis = None

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 padding: Padding = ((2, 1), (2, 1)), use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.padding, self.dtype, self.features = padding, dtype, features
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, kernel_size, kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def _conv(self, x: torch.Tensor, weight: torch.Tensor, bias, up_rows=None) -> torch.Tensor:
        """``up_rows`` (start, stop, top, bottom) on row shards: the
        upsampled window's rows [start, stop), with ``top`` and ``bottom``
        zero rows, convolved with no row padding."""
        up = F.interpolate(x.to(self.dtype).permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        up = up.permute(0, 2, 3, 1)
        padding = self.padding
        if up_rows is not None:
            start, stop, top, bottom = up_rows
            up = up[:, start:stop]
            if top or bottom:
                up = torch.cat([up.new_zeros((up.shape[0], top, *up.shape[2:])), up,
                                up.new_zeros((up.shape[0], bottom, *up.shape[2:]))], dim=1)
            padding = ((0, 0), padding[1])
        return _conv_nhwc(up, weight, bias, 1, padding, self.dtype)

    def _run(self, x: torch.Tensor, up_rows=None) -> torch.Tensor:
        conv = functools.partial(self._conv, up_rows=up_rows)
        if self.tensor_axis is not None:
            return column_parallel(self, x, conv)
        return conv(x, self.weight, self.bias)

    def out_height(self, h: int) -> int:
        (pt, pb), _ = self.padding
        return 2 * h + pt + pb - self.weight.shape[2] + 1

    def forward(self, x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
        if not sharded(rows):
            return self._run(x)
        (pt, _), _ = self.padding
        k, h2 = self.weight.shape[2], 2 * rows.h

        def up_span(lo, hi):  # the upsampled rows that output rows [lo, hi) read
            return lo - pt, hi - 1 - pt + k

        def need(lo, hi):
            ua, ub = up_span(lo, hi)
            return ua // 2, (ub - 1) // 2 + 1

        def compute(xw, a, b, lo, hi):  # xw: input rows [a, b), upsampled rows [2a, 2b)
            ua, ub = up_span(lo, hi)
            start, stop = max(ua, 0), min(ub, h2)
            return self._run(xw, (start - 2 * a, stop - 2 * a, start - ua, ub - stop))

        return row_op(x, rows, self.out_height(rows.h), need, compute, edge="clip")
