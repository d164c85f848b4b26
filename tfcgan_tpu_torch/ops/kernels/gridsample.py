"""Wrappers of the hand-written dense bilinear grid_sample kernels
(``csrc/gridsample.cu``).

``gridsample_fwd`` samples an NHWC image (float32 or bfloat16) at a float32
normalized ``(N, Hg, Wg, 2)`` grid; ``gridsample_bwd`` is its exact backward:
the image gradient (float32, summed with atomics into a buffer the launch
zeroes itself) and the grid gradient (one writer per element, its channel
shares summed in a fixed order), each computed only when asked for. They
replace the TPU kernels of ``tfcgan_tpu/ops/pallas_kernels/gridsample.py``
(``_sample_padded``, ``_sp_bwd``). Bytes bound both; the backward waits for its
atomics, which its threads issue per (pixel, channel), channels fastest, so
that a warp's land on a few contiguous L2 sectors. Both launch on PyTorch's current stream for CUDA tensors
and raise on anything the kernels do not take. They never copy and never fall
back. The plain PyTorch version is ``tfcgan_tpu_torch.ops.warp.grid_sample``
with ``mode="bilinear"``; autograd of it is the plain version of the backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tfcgan_tpu_torch.ops.kernels._build import load_library

# kernel launches made by this process, forward and backward; chip_smoke.py
# resets and reads them
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

PADDING_MODES = ("zeros", "border", "reflection")  # the kernels' padding codes 0, 1, 2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_LIMIT = 2**31 - 1
_THREADS = 256  # kThreads in csrc/gridsample.cu

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_TAIL = [_INT] * 9 + [_PTR]  # n, h, w, c, hg, wg, padding, align, dtype, stream
_ARGTYPES = {"tfcgan_gridsample_fwd": [_PTR] * 3 + _TAIL,
             "tfcgan_gridsample_bwd": [_PTR] * 5 + _TAIL}


@functools.cache
def _fn(name: str):
    fn = getattr(load_library("gridsample"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(what: str, inp: torch.Tensor, grid: torch.Tensor, padding_mode: str) -> None:
    if inp.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got inp on {inp.device}")
    if inp.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes a float32 or bfloat16 inp, got {inp.dtype}")
    if inp.dim() != 4 or not inp.is_contiguous():
        raise ValueError(f"{what} takes a contiguous NHWC inp, got shape {tuple(inp.shape)} "
                         f"strides {inp.stride()}")
    if grid.dtype != torch.float32:
        raise TypeError(f"{what} takes a float32 grid, got {grid.dtype}")
    if (grid.device != inp.device or grid.dim() != 4 or grid.shape[0] != inp.shape[0]
            or grid.shape[3] != 2 or not grid.is_contiguous()):
        raise ValueError(f"{what} takes a contiguous (N, Hg, Wg, 2) grid on {inp.device} for "
                         f"inp {tuple(inp.shape)}, got shape {tuple(grid.shape)} strides "
                         f"{grid.stride()} on {grid.device}")
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"padding_mode must be one of {PADDING_MODES}, got {padding_mode!r}")
    n, h, w, c = inp.shape
    if min(h, w, c) < 1:
        raise ValueError(f"{what}: inp {tuple(inp.shape)} has an empty image")
    pixels = n * grid.shape[1] * grid.shape[2]
    if (inp.numel() > _INT_LIMIT or pixels > _INT_LIMIT or pixels * c > _INT_LIMIT * _THREADS
            or c * _THREADS > _INT_LIMIT):
        raise ValueError(f"{what}: inp {tuple(inp.shape)} with grid {tuple(grid.shape)} exceeds "
                         "the kernel's launch grid")


def _launch(name: str, pointers, inp: torch.Tensor, grid: torch.Tensor, padding_mode: str,
            align_corners: bool) -> None:
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        err = _fn(name)(*pointers, *inp.shape, grid.shape[1], grid.shape[2],
                        PADDING_MODES.index(padding_mode), int(bool(align_corners)),
                        _DTYPE_CODES[inp.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def gridsample_fwd(inp: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros",
                   align_corners: bool = False) -> torch.Tensor:
    """out[n, i, j, :] = bilinear sample of inp[n] at grid[n, i, j] = (x, y);
    float32 arithmetic, (N, Hg, Wg, C) in inp's dtype."""
    global FWD_LAUNCHES
    _check("gridsample_fwd", inp, grid, padding_mode)
    out = torch.empty((*grid.shape[:3], inp.shape[3]), dtype=inp.dtype, device=inp.device)
    if out.numel() == 0:
        return out
    _launch("tfcgan_gridsample_fwd", (inp.data_ptr(), grid.data_ptr(), out.data_ptr()), inp,
            grid, padding_mode, align_corners)
    FWD_LAUNCHES += 1
    return out


def gridsample_bwd(g: torch.Tensor, inp: torch.Tensor, grid: torch.Tensor,
                   padding_mode: str = "zeros", align_corners: bool = False,
                   need_inp: bool = True, need_grid: bool = True
                   ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The gradients of ``gridsample_fwd`` to inp (float32, inp's shape) and to
    grid (float32, grid's shape) for the output gradient ``g`` (inp's dtype,
    the output's shape); None for the one not asked for."""
    global BWD_LAUNCHES
    _check("gridsample_bwd", inp, grid, padding_mode)
    if (g.device != inp.device or g.dtype != inp.dtype or not g.is_contiguous()
            or tuple(g.shape) != (*grid.shape[:3], inp.shape[3])):
        raise ValueError(f"gridsample_bwd: g must be a contiguous {inp.dtype} "
                         f"{(*grid.shape[:3], inp.shape[3])} tensor on {inp.device}, got "
                         f"{g.dtype} {tuple(g.shape)} strides {g.stride()} on {g.device}")
    if not (need_inp or need_grid):
        return None, None
    d_grid = torch.empty_like(grid) if need_grid else None
    if g.numel() == 0:
        return (torch.zeros(inp.shape, dtype=torch.float32, device=inp.device)
                if need_inp else None), d_grid
    # zeroed by the launch itself, on its stream
    d_inp = (torch.empty(inp.shape, dtype=torch.float32, device=inp.device)
             if need_inp else None)
    _launch("tfcgan_gridsample_bwd",
            (g.data_ptr(), inp.data_ptr(), grid.data_ptr(),
             None if d_inp is None else d_inp.data_ptr(),
             None if d_grid is None else d_grid.data_ptr()),
            inp, grid, padding_mode, align_corners)
    BWD_LAUNCHES += 1
    return d_inp, d_grid
