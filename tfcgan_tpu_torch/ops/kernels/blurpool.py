"""Wrapper of the hand-written blur-pool forward kernel (``csrc/blurpool.cu``).

``blur_pool_fwd`` launches the kernel on PyTorch's current stream for a CUDA
tensor and raises on anything the kernel does not take. It never copies and
never falls back: a non-contiguous input is an error, so that a hidden layout
copy on the main path shows up instead of costing time. The plain PyTorch
version of the same function is ``tfcgan_tpu_torch.ops.blurpool.blur_pool_padded``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tfcgan_tpu_torch.ops.kernels._build import load_library

# kernel launches made by this process; chip_smoke.py resets and reads it
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 2**31 - 1
_THREADS = 256  # kThreads in csrc/blurpool.cu
_GRID_Y_LIMIT = 65535


@functools.cache
def _fn():
    fn = load_library("blurpool").tfcgan_blurpool_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def out_len(n: int, stride: int) -> int:
    """Output length of one axis: reflect pad (1, 2), 4 taps, the stride."""
    return (n - 1) // stride + 1


def blur_pool_fwd(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Blur-pool of an NHWC-contiguous float32/bfloat16 CUDA tensor."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"blur_pool_fwd takes a CUDA tensor, got one on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"blur_pool_fwd takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            f"blur_pool_fwd takes a contiguous NHWC tensor, got shape {tuple(x.shape)} "
            f"strides {x.stride()}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    n, h, w, c = x.shape
    ho, wo = out_len(h, stride), out_len(w, stride)
    if n * ho > _GRID_LIMIT or w * c > _GRID_LIMIT or -(-wo * c // _THREADS) > _GRID_Y_LIMIT:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's launch grid")
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), n, h, w, c, ho, wo, stride,
                 _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"blurpool kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return y
