"""1-D affine resampling with exact gradients and the two-pass separable
affine warp, port of ``tfcgan_tpu.ops.pallas_kernels.resample``.

``resample_axis(x, p, q, l_out, mode, border, channels, o_base)`` resamples
the middle axis of a contiguous ``(outer, length, inner)`` view: element
``(o, i, j)`` of the output is ``x[o, :, j]`` interpolated at ``p*(o_base +
i) + q`` of the line ``(o, j // channels)`` (``o_base`` 0 but for a window of
a longer line's outputs), with the linear (2 taps) or Keys cubic A=-0.75 (4
taps) kernel; taps beyond the ends read the edge element (``border``) or 0.
float32 accumulation and output. A CUDA tensor goes through ``ResampleAffine``,
the autograd function around the three hand-written kernels
(``ops/kernels/resample.py``); a CPU tensor goes to ``resample_axis_plain``,
the same taps with ``torch.gather``, whose autograd gradient is the exact
adjoint (clamped gathers scatter-add onto the edge) and the position gradient.

``resample_affine_lanes`` is the JAX function's signature on top of it (rows
``(R, W*stride)`` with channel-interleaved lanes), and
``warp_affine_separable`` builds the affine warp from an x-pass over
``(N*H, W, C)`` and a y-pass over ``(N, H, W*C)``: the same two-pass form as
the JAX package's default warp. It equals the direct 2-D warp
(``ops/warp.warp_affine``) for axis-aligned scales and translations; under
shear or rotation the second pass interpolates values the first pass already
interpolated, which differs a little (the tests bound it).

On row shards (``rows``, the spatial mesh axis) the warp reads the source
anywhere: theta can put an output row's samples on any source row. The
x-pass runs on this rank's source rows (their global indices in q), the
float32 intermediate is gathered once over the spatial group
(``parallel.spatial.gather_spatial``), and the y-pass computes this rank's
output rows from it (``o_base`` their first row): the shard's output equals
those rows of the whole warp bit for bit. The intermediate's gradient is then
whole on every rank, and the gather's backward sums it onto each owner's rows.
"""

from __future__ import annotations

import torch

from tfcgan_tpu_torch.ops.kernels import resample as _kernel
from tfcgan_tpu_torch.parallel.spatial import Rows, gather_spatial

_A = -0.75
_HALF_SUPPORT = {"linear": 1, "cubic": 2}


def _k_linear(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 1.0 - ax, torch.zeros_like(ax))


def _k_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel, A = -0.75, support (-2, 2)."""
    ax = x.abs()
    in1 = ((_A + 2.0) * ax - (_A + 3.0)) * ax * ax + 1.0
    in2 = ((_A * ax - 5.0 * _A) * ax + 8.0 * _A) * ax - 4.0 * _A
    return torch.where(ax <= 1.0, in1, torch.where(ax < 2.0, in2, torch.zeros_like(ax)))


def resample_axis_plain(x: torch.Tensor, p: torch.Tensor, q: torch.Tensor, l_out: int,
                        mode: str = "linear", border: bool = True, channels: int = 1,
                        o_base: int = 0) -> torch.Tensor:
    """The plain version: x (outer, l_in, inner), p and q (outer, inner //
    channels) -> float32 (outer, l_out, inner), the outputs o_base .. o_base +
    l_out - 1 of each line. Differentiable in x, p and q."""
    if mode not in _HALF_SUPPORT:
        raise ValueError(f"mode must be one of {tuple(_HALF_SUPPORT)}, got {mode!r}")
    hs = _HALF_SUPPORT[mode]
    kfn = _k_linear if mode == "linear" else _k_cubic
    outer, l_in, inner = x.shape
    x = x.float()
    steps = torch.arange(o_base, o_base + l_out, dtype=torch.float32,
                         device=x.device)[None, :, None]
    pos = p.float()[:, None, :] * steps + q.float()[:, None, :]  # (outer, l_out, lines)
    pos = pos.repeat_interleave(channels, dim=2)
    i0 = torch.floor(pos)
    t = pos - i0
    out = torch.zeros((outer, l_out, inner), dtype=torch.float32, device=x.device)
    for k in range(-hs + 1, hs + 1):
        idx = i0 + k
        tap = torch.gather(x, 1, idx.clamp(0, l_in - 1).long())
        if not border:
            tap = torch.where((idx >= 0) & (idx < l_in), tap, torch.zeros_like(tap))
        out = out + tap * kfn(t - k)
    return out


class ResampleAffine(torch.autograd.Function):
    """The three kernels as one differentiable op on CUDA tensors: the forward,
    and in the backward the exact adjoint (for x) and the position gradient
    (for p and q), each launched only where autograd asks for its result."""

    @staticmethod
    def forward(ctx, x, p, q, l_out: int, mode: str, border: bool, channels: int,
                o_base: int = 0):
        ctx.save_for_backward(x, p, q)
        ctx.args = (mode, border, channels, o_base)
        return _kernel.resample_fwd(x, p, q, l_out, mode, border, channels, o_base)

    @staticmethod
    def backward(ctx, g):
        x, p, q = ctx.saved_tensors
        g = g.contiguous()
        gx = gp = gq = None
        if ctx.needs_input_grad[0]:
            gx = _kernel.resample_adjoint(g, p, q, x.shape[1], *ctx.args).to(x.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            gp, gq = _kernel.resample_gradpos(x, g, p, q, *ctx.args)
        return gx, gp, gq, None, None, None, None, None


def resample_axis(x: torch.Tensor, p: torch.Tensor, q: torch.Tensor, l_out: int,
                  mode: str = "linear", border: bool = True, channels: int = 1,
                  o_base: int = 0) -> torch.Tensor:
    """The kernels on CUDA (forward and, where autograd needs them, backward),
    the plain version on the CPU."""
    if x.device.type == "cpu":
        return resample_axis_plain(x, p, q, l_out, mode, border, channels, o_base)
    return ResampleAffine.apply(x, p.float().contiguous(), q.float().contiguous(), l_out, mode,
                                border, channels, o_base)


def resample_affine_lanes(x: torch.Tensor, p: torch.Tensor, q: torch.Tensor, w_out: int,
                          mode: str = "linear", border: bool = True, stride: int = 1
                          ) -> torch.Tensor:
    """out[r, i] = interp(x[r, :]) at p[r]*i + q[r]; x: (R, W_in * stride) with
    channel-interleaved lanes l = pixel*stride + channel, p and q: (R,).
    Returns float32 (R, w_out * stride)."""
    rows, lanes = x.shape
    out = resample_axis(x.view(rows, lanes // stride, stride), p.view(rows, 1), q.view(rows, 1),
                        w_out, mode, border, stride)
    return out.view(rows, w_out * stride)


def resample_affine_lanes_plain(x, p, q, w_out, mode="linear", border=True, stride=1):
    """``resample_affine_lanes`` through the plain version on any device."""
    rows, lanes = x.shape
    out = resample_axis_plain(x.view(rows, lanes // stride, stride), p.view(rows, 1),
                              q.view(rows, 1), w_out, mode, border, stride)
    return out.view(rows, w_out * stride)


def _pixel_affine(theta: torch.Tensor, h: int, w: int):
    """Normalized-coordinate affine (align_corners=True) -> pixel space:
    xs = P*x + Q*y + R, ys = P2*x + Q2*y + R2 (x, y in pixels), each (N,)."""
    a, b, t1 = theta[:, 0, 0], theta[:, 0, 1], theta[:, 0, 2]
    c, d, t2 = theta[:, 1, 0], theta[:, 1, 1], theta[:, 1, 2]
    wm, hm = float(w - 1), float(h - 1)
    return (a, b * (wm / hm), 0.5 * wm * (t1 + 1.0) - 0.5 * (a * wm + b * wm),
            c * (hm / wm), d, 0.5 * hm * (t2 + 1.0) - 0.5 * (c * hm + d * hm))


def warp_affine_separable(src: torch.Tensor, theta: torch.Tensor, mode: str = "bicubic",
                          padding_mode: str = "border", rows: Rows | None = None
                          ) -> torch.Tensor:
    """Two-pass separable affine warp, differentiable in src and theta.

    src: (N, H, W, C), any strides (a non-contiguous one is copied once);
    theta: (N, 2, 3), normalized,
    align_corners=True; needs theta[:, 1, 1] != 0. ``padding_mode="zeros"``
    masks the border-clamped result where the direct warp would sample outside
    the image. With ``rows`` src is this rank's rows of images of ``rows.h``
    rows, and so is the result (see the module docstring)."""
    n, nl, w, c = src.shape
    h, lo = (nl, 0) if rows is None else (rows.h, rows.lo)
    kmode = "linear" if mode == "bilinear" else "cubic"
    P, Q, R, P2, Q2, R2 = _pixel_affine(theta.float(), h, w)
    xs = torch.arange(w, dtype=torch.float32, device=src.device)
    ys = torch.arange(lo, lo + nl, dtype=torch.float32, device=src.device)  # global rows

    # x-pass: the image as (N*H, W, C), one line per source row
    p_eff = P - Q * P2 / Q2
    q_eff = Q / Q2
    r_eff = R - Q * R2 / Q2
    p1 = p_eff[:, None].expand(n, nl).reshape(n * nl, 1)
    q1 = (q_eff[:, None] * ys[None, :] + r_eff[:, None]).reshape(n * nl, 1)
    tmp = resample_axis(src.reshape(n * nl, w, c), p1, q1, w, kmode, True, c)

    # y-pass: the float32 intermediate as (N, H, W*C), one line per column;
    # on row shards the whole intermediate, and this rank's output rows
    tmp = gather_spatial(tmp.view(n, nl, w, c), rows)
    p2 = Q2[:, None].expand(n, w)
    q2 = P2[:, None] * xs[None, :] + R2[:, None]
    out = resample_axis(tmp.reshape(n, h, w * c), p2, q2, nl, kmode, True, c,
                        lo).view(n, nl, w, c)

    if padding_mode == "zeros":
        gx, gy = xs[None, None, :], ys[None, :, None]
        xs2 = P[:, None, None] * gx + Q[:, None, None] * gy + R[:, None, None]
        ys2 = P2[:, None, None] * gx + Q2[:, None, None] * gy + R2[:, None, None]
        inside = (xs2 >= 0) & (xs2 <= w - 1) & (ys2 >= 0) & (ys2 <= h - 1)
        out = out * inside[..., None]
    return out.to(src.dtype)
