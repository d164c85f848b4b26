"""Wrappers of the hand-written blur-pool kernels (``csrc/blurpool.cu``).

``blur_pool_fwd`` and ``blur_pool_bwd`` (its exact adjoint) launch on
PyTorch's current stream for CUDA tensors and raise on anything the kernels do
not take. Both take a row window ``(h_glob, row0, o_base)`` (the row-edge
form, for the spatial mesh axis): the input is rows [row0, row0 + h) of a map
of ``h_glob`` rows, the output that map's output rows from ``o_base``, and
only the map's own top and bottom edges reflect; the default window is the
whole map, ``(h, 0, 0)``. They never copy and never fall back: a non-contiguous input is an
error, so that a hidden layout copy on the main path shows up instead of
costing time. The plain PyTorch version of the forward is
``tfcgan_tpu_torch.ops.blurpool.blur_pool_padded``; autograd of it is the
plain version of the backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tfcgan_tpu_torch.ops.kernels._build import load_library

# kernel launches made by this process, forward and backward; chip_smoke.py
# resets and reads them
LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_LIMIT = 2**31 - 1


@functools.cache
def _fn(name: str):
    fn = getattr(load_library("blurpool"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def out_len(n: int, stride: int) -> int:
    """Output length of one axis: reflect pad (1, 2), 4 taps, the stride."""
    return (n - 1) // stride + 1


def window_rows(h_glob: int, o_base: int, ho: int, stride: int) -> tuple[int, int]:
    """The rows [a, b) of an ``h_glob``-row map that its output rows
    [o_base, o_base + ho) read, reflected at the map's edges."""
    j0, j1 = stride * o_base - 1, stride * (o_base + ho - 1) + 3
    lo, hi = max(j0, 0), min(j1, h_glob)
    # the reads past an edge (j = -1, h_glob, h_glob + 1) reflect inward
    edge = [reflect_index(j, h_glob) for j in (*range(j0, min(j1, 0)),
                                               *range(max(j0, h_glob), j1))]
    if hi <= lo:
        return min(edge), max(edge) + 1
    return min([lo, *edge]), max([hi - 1, *edge]) + 1


def reflect_index(j: int, n: int) -> int:
    """Reflection without repeating the edge sample, for every n >= 1 and any
    j (``_reflect`` of the TPU kernel's module, also used by csrc/blurpool.cu).
    Unlike ``F.pad(mode="reflect")`` it takes pads as long as the axis or
    longer, which the generator reaches at 64² (n = 1 at down6, 2 at up1)."""
    if n == 1:
        return 0
    j = j % (2 * (n - 1))
    return j if j < n else 2 * (n - 1) - j


def _check(t: torch.Tensor, what: str, stride: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA tensor, got one on {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{what} takes a contiguous NHWC tensor, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")


def _launch(name: str, src: torch.Tensor, dst: torch.Tensor, n: int, h: int, w: int, c: int,
            stride: int, ho: int, window: tuple[int, int, int]) -> None:
    """One call over ``dst``, a grid dimension for the images (the forward:
    a thread a strip of output rows and up to 16 bytes of channels; the
    backward: a thread a 2 x 2 block of pixels and up to 16 bytes of
    channels); (n, h, w, c) is the forward's input shape. The C entries launch
    more than 65535 images in several grids, and refuse (with an error code) a
    grid of more than 65535 column chunks."""
    if w * c > _INT_LIMIT:
        raise ValueError(f"shape {tuple(dst.shape)} exceeds the kernel's launch grid")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        args = (src.data_ptr(), dst.data_ptr(), n, h, w, c, ho, out_len(w, stride), stride,
                _DTYPE_CODES[src.dtype], stream)
        err = _fn(name)(*args, *window)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _check_window(window, h: int, ho: int, stride: int) -> None:
    """A row window (h_glob, row0, o_base) must hold every row its ``ho``
    outputs read."""
    h_glob, row0, o_base = window
    if not (0 <= row0 and row0 + h <= h_glob and 0 <= o_base
            and o_base + ho <= out_len(h_glob, stride)):
        raise ValueError(f"row window {window} does not fit {h} input and {ho} output rows")
    a, b = window_rows(h_glob, o_base, ho, stride)
    if ho and (a < row0 or b > row0 + h):
        raise ValueError(f"output rows [{o_base}, {o_base + ho}) of a {h_glob}-row map read "
                         f"rows [{a}, {b}), outside the window's [{row0}, {row0 + h})")


def blur_pool_fwd(x: torch.Tensor, stride: int, window=None, ho: int | None = None
                  ) -> torch.Tensor:
    """Blur-pool of an NHWC-contiguous float32/bfloat16 CUDA tensor; with
    ``window=(h_glob, row0, o_base)``, its output rows [o_base, o_base + ho)
    (the row-edge form; by default the whole map)."""
    global LAUNCHES
    _check(x, "blur_pool_fwd", stride)
    n, h, w, c = x.shape
    if window is None:  # the whole map, which holds every row its outputs read
        window, ho = (h, 0, 0), out_len(h, stride)
    else:
        _check_window(window, h, ho, stride)
    y = torch.empty((n, ho, out_len(w, stride), c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    _launch("tfcgan_blurpool_fwd", x, y, n, h, w, c, stride, ho, window)
    LAUNCHES += 1
    return y


def blur_pool_bwd(dy: torch.Tensor, h: int, w: int, stride: int, window=None) -> torch.Tensor:
    """The gradient of ``blur_pool_fwd`` at an (N, h, w, C) input for the
    NHWC-contiguous output gradient ``dy``; dx has dy's dtype. With
    ``window=(h_glob, row0, o_base)`` the adjoint of the row-edge form: dy is
    the output rows [o_base, o_base + ho) and dx the window's h rows."""
    global BWD_LAUNCHES
    _check(dy, "blur_pool_bwd", stride)
    n, ho, wo, c = dy.shape
    whole_ho = out_len(h, stride) if window is None else ho
    if (ho, wo) != (whole_ho, out_len(w, stride)):
        raise ValueError(f"dy of shape {tuple(dy.shape)} is not the stride-{stride} "
                         f"output of an input with H={h}, W={w}")
    if window is None:
        window = (h, 0, 0)
    else:
        _check_window(window, h, ho, stride)
    dx = torch.empty((n, h, w, c), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    if dy.numel() == 0:
        return dx.zero_()
    _launch("tfcgan_blurpool_bwd", dy, dx, n, h, w, c, stride, ho, window)
    BWD_LAUNCHES += 1
    return dx
