"""Wrappers of the hand-written 1-D affine resampling kernels (``csrc/resample.cu``).

All three work on the view ``(outer, length, inner)`` of a contiguous tensor:
the middle axis is resampled, ``inner`` is the contiguous rest, and every
``channels`` neighbouring elements of ``inner`` share one line, that is one
``(p, q)`` pair; ``p`` and ``q`` are float32 ``(outer, inner // channels)``.
The x-pass of the separable warp sees an NHWC image as ``(N*H, W, C)``, the
y-pass as ``(N, H, W*C)``.

``resample_fwd``, ``resample_adjoint`` (the exact transpose, with the clamped
taps' mass on the two edge elements) and ``resample_gradpos`` (the gradient to
``p`` and ``q``, reduced per line in the kernel) launch one kernel each on
PyTorch's current stream for CUDA tensors and raise on anything the kernels
do not take. They never copy and never fall back, and allocate only their
results. Each kernel thread takes one (line, position) or (line, element) and
all of the line's channels, so ``channels`` is any count that divides
``inner``; the adjoint and the position gradient sum in a fixed order and
repeat bit for bit. The plain PyTorch version is
``tfcgan_tpu_torch.ops.resample.resample_axis_plain``; autograd of it is the
plain version of the two backward kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tfcgan_tpu_torch.ops.kernels._build import load_library

# kernel launches made by this process, one count per wrapper; chip_smoke.py
# resets and reads them
FWD_LAUNCHES = 0
ADJOINT_LAUNCHES = 0
GRADPOS_LAUNCHES = 0

MODES = ("linear", "cubic")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 2**31 - 1
# grid.y chunks of 256 threads over l_out * lines (the forward) or l_in / 4 *
# lines (the adjoint), checked on length * inner
_PLANE_LIMIT = 65535 * 256

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SHAPE_ARGS = [ctypes.c_int64, _INT, _INT, _INT, _INT, _INT, _INT]  # outer .. border
_ARGTYPES = {
    "tfcgan_resample_fwd": [_PTR] * 4 + _SHAPE_ARGS + [_INT, _PTR],
    "tfcgan_resample_adjoint": [_PTR] * 4 + _SHAPE_ARGS + [_PTR],
    "tfcgan_resample_gradpos": [_PTR] * 6 + _SHAPE_ARGS + [_INT, _PTR],
}


@functools.cache
def _fn(name: str):
    fn = getattr(load_library("resample"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_view(t: torch.Tensor, what: str, dtypes) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA tensor, got one on {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} takes {' or '.join(str(d) for d in dtypes)}, got {t.dtype}")
    if t.dim() != 3 or not t.is_contiguous():
        raise ValueError(f"{what} takes a contiguous (outer, length, inner) tensor, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _check(what: str, t: torch.Tensor, p: torch.Tensor, q: torch.Tensor, length: int,
           mode: str, channels: int, dtypes=(torch.float32,)) -> None:
    """``t`` is the view the kernel reads, ``length`` the other side's length."""
    _check_view(t, what, dtypes)
    outer, t_len, inner = t.shape
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    # a thread loops over a line's channels: any count >= 1 that divides inner
    if channels < 1 or inner % channels:
        raise ValueError(f"{what}: inner {inner} must be a multiple of channels {channels}")
    if t_len < 1 or length < 1:
        raise ValueError(f"{what}: lengths must be >= 1, got {t_len} and {length}")
    if outer > _GRID_LIMIT or max(t_len, length) * inner > _PLANE_LIMIT:
        raise ValueError(f"{what}: shape {tuple(t.shape)} exceeds the kernel's launch grid")
    lines = (outer, inner // channels)
    for name, c in (("p", p), ("q", q)):
        if (c.device != t.device or c.dtype != torch.float32 or tuple(c.shape) != lines
                or not c.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous float32 {lines} tensor on "
                             f"{t.device}, got {c.dtype} {tuple(c.shape)} on {c.device}")


def _launch(name: str, tensors, lengths, mode: str, border: bool, tail, device) -> None:
    """``lengths``: (outer, l_in, l_out, inner, channels)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _fn(name)(*(t.data_ptr() for t in tensors), *lengths, int(mode == "cubic"),
                        int(bool(border)), *tail, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def resample_fwd(x: torch.Tensor, p: torch.Tensor, q: torch.Tensor, l_out: int, mode: str,
                 border: bool, channels: int) -> torch.Tensor:
    """out[o, i, j] = interp(x[o, :, j]) at p*i + q of the line of (o, j);
    x float32 or bfloat16, out float32 (outer, l_out, inner)."""
    global FWD_LAUNCHES
    _check("resample_fwd", x, p, q, l_out, mode, channels, tuple(_DTYPE_CODES))
    outer, l_in, inner = x.shape
    out = torch.empty((outer, l_out, inner), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _launch("tfcgan_resample_fwd", (x, p, q, out),
            (outer, l_in, l_out, inner, channels), mode, border,
            (_DTYPE_CODES[x.dtype],), x.device)
    FWD_LAUNCHES += 1
    return out


def resample_adjoint(g: torch.Tensor, p: torch.Tensor, q: torch.Tensor, l_in: int, mode: str,
                     border: bool, channels: int) -> torch.Tensor:
    """The gradient of ``resample_fwd`` to x (float32, (outer, l_in, inner))
    for the float32 output gradient ``g`` (outer, l_out, inner). One launch:
    the kernel adds the edge masses of border clamping itself."""
    global ADJOINT_LAUNCHES
    _check("resample_adjoint", g, p, q, l_in, mode, channels)
    outer, l_out, inner = g.shape
    dx = torch.empty((outer, l_in, inner), dtype=torch.float32, device=g.device)
    if dx.numel() == 0:
        return dx
    _launch("tfcgan_resample_adjoint", (g, p, q, dx),
            (outer, l_in, l_out, inner, channels), mode, border, (), g.device)
    ADJOINT_LAUNCHES += 1
    return dx


def resample_gradpos(x: torch.Tensor, g: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                     mode: str, border: bool, channels: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``resample_fwd`` to p and q (float32, p's shape) for
    the forward's input ``x`` and the float32 output gradient ``g``."""
    global GRADPOS_LAUNCHES
    _check_view(g, "resample_gradpos", (torch.float32,))
    outer, l_out, inner = g.shape
    _check("resample_gradpos", x, p, q, l_out, mode, channels, tuple(_DTYPE_CODES))
    if g.device != x.device or (x.shape[0], x.shape[2]) != (outer, inner):
        raise ValueError(f"resample_gradpos: g {tuple(g.shape)} on {g.device} does not belong "
                         f"to x {tuple(x.shape)} on {x.device}")
    gp, gq = torch.empty_like(p), torch.empty_like(q)
    if gp.numel() == 0:
        return gp, gq
    _launch("tfcgan_resample_gradpos", (x, g, p, q, gp, gq),
            (outer, x.shape[1], l_out, inner, channels), mode, border,
            (_DTYPE_CODES[x.dtype],), x.device)
    GRADPOS_LAUNCHES += 1
    return gp, gq
