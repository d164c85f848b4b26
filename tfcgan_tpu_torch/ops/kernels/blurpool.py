"""Wrappers of the hand-written blur-pool kernels (``csrc/blurpool.cu``).

``blur_pool_fwd`` and ``blur_pool_bwd`` (its exact adjoint) launch on
PyTorch's current stream for CUDA tensors and raise on anything the kernels do
not take. They never copy and never fall back: a non-contiguous input is an
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
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def out_len(n: int, stride: int) -> int:
    """Output length of one axis: reflect pad (1, 2), 4 taps, the stride."""
    return (n - 1) // stride + 1


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
            stride: int) -> None:
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
        err = _fn(name)(src.data_ptr(), dst.data_ptr(), n, h, w, c, out_len(h, stride),
                        out_len(w, stride), stride, _DTYPE_CODES[src.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def blur_pool_fwd(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Blur-pool of an NHWC-contiguous float32/bfloat16 CUDA tensor."""
    global LAUNCHES
    _check(x, "blur_pool_fwd", stride)
    n, h, w, c = x.shape
    y = torch.empty((n, out_len(h, stride), out_len(w, stride), c), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    _launch("tfcgan_blurpool_fwd", x, y, n, h, w, c, stride)
    LAUNCHES += 1
    return y


def blur_pool_bwd(dy: torch.Tensor, h: int, w: int, stride: int) -> torch.Tensor:
    """The gradient of ``blur_pool_fwd`` at an (N, h, w, C) input for the
    NHWC-contiguous output gradient ``dy``; dx has dy's dtype."""
    global BWD_LAUNCHES
    _check(dy, "blur_pool_bwd", stride)
    n, ho, wo, c = dy.shape
    if (ho, wo) != (out_len(h, stride), out_len(w, stride)):
        raise ValueError(f"dy of shape {tuple(dy.shape)} is not the stride-{stride} "
                         f"output of an input with H={h}, W={w}")
    dx = torch.empty((n, h, w, c), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    _launch("tfcgan_blurpool_bwd", dy, dx, n, h, w, c, stride)
    BWD_LAUNCHES += 1
    return dx
