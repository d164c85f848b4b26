"""Wrappers of the hand-written flash attention kernels (``csrc/flashattn.cu``).

``flashattn_fwd`` computes ``o = softmax(q^T k * scale) v`` per (batch, head)
and the log-sum-exp of the scores; ``flashattn_bwd`` the gradients to q, k and
v from the saved log-sum-exp, as two kernels (dq, and dk with dv), each
launched only when a gradient it computes is asked for. They replace the TPU
kernels of ``tfcgan_tpu/ops/pallas_kernels/flashattn.py`` (``_flash_fwd_impl``,
``_flash_vjp_bwd``). The C entries choose every kernel by type: bfloat16 runs
on the tensor cores (a warp per 16 queries or keys, ``mma.sync``, one
exponential a query-key pair left on the other units: what bounds them),
float32 on the float32 units (a thread per query or key, bound by the rate at
which an SM issues operations; TF32 would miss the float32 window). Every
tensor is a ``(N, H, D, S)`` view of any strides, float32 or bfloat16: the
kernels read and write through the strides, so the wrappers never copy. They launch on PyTorch's current stream for CUDA tensors
and raise on anything the kernels do not take; they never fall back. The
plain PyTorch version is ``tfcgan_tpu_torch.ops.flashattn.flash_attention_plain``;
autograd of it is the plain version of the backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tfcgan_tpu_torch.ops.kernels._build import load_library

# kernel launches made by this process, one count per __global__ kernel;
# chip_smoke.py resets and reads them
FWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
# of those launches, the bfloat16 ones: the tensor-core kernels
FWD_TC_LAUNCHES = 0
DQ_TC_LAUNCHES = 0
DKV_TC_LAUNCHES = 0

HEAD_DIMS = (8, 16, 32, 64)  # the D the kernels are instantiated for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_LIMIT = 2**31 - 1
_ROWS = 64  # the fewest rows a block owns in csrc/flashattn.cu (kTcRows)

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# strides, n, heads, s, d, scale, dtype, stream
_TAIL = [_PTR, _INT, _INT, _INT, _INT, _FLOAT, _INT, _PTR]
_ARGTYPES = {"tfcgan_flashattn_fwd": [_PTR] * 5 + _TAIL,
             "tfcgan_flashattn_bwd_dq": [_PTR] * 7 + _TAIL,
             "tfcgan_flashattn_bwd_dkv": [_PTR] * 8 + _TAIL}


@functools.cache
def _fn(name: str):
    fn = getattr(load_library("flashattn"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(what: str, q: torch.Tensor, others: dict[str, torch.Tensor]) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got q on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16 tensors, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"{what} takes (N, H, D, S) views, got q of shape {tuple(q.shape)}")
    n, h, d, s = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} is not one of {HEAD_DIMS}")
    if min(n, h, s) < 1:
        raise ValueError(f"{what}: empty shape {tuple(q.shape)}")
    if n * h * ((s + _ROWS - 1) // _ROWS) > _INT_LIMIT:
        raise ValueError(f"{what}: shape {tuple(q.shape)} exceeds the kernel's launch grid")
    for name, t in others.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: {name} must be a {q.dtype} {tuple(q.shape)} tensor on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_stat(what: str, name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    if (t.shape != (q.shape[0], q.shape[1], q.shape[3]) or t.dtype != torch.float32
            or t.device != q.device or not t.is_contiguous()):
        raise ValueError(f"{what}: {name} must be a contiguous float32 (N, H, S) tensor on "
                         f"{q.device}, got {t.dtype} {tuple(t.shape)} strides {t.stride()}")


def _launch(name: str, pointers, views, q: torch.Tensor, scale: float) -> None:
    strides = [s for t in views for s in (t.stride() if t is not None else (0, 0, 0, 0))]
    table = (ctypes.c_int64 * len(strides))(*strides)
    n, h, d, s = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(name)(*pointers, ctypes.addressof(table), n, h, s, d, float(scale),
                        _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def flashattn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): o[n, h, :, i] = sum_j softmax_j(q[n, h, :, i] . k[n, h, :, j] *
    scale) v[n, h, :, j] in q's dtype and, where q is dense, q's memory order;
    lse (N, H, S) float32, the log-sum-exp of each query's scaled scores. In
    bfloat16 the kernel is the tensor-core one."""
    global FWD_LAUNCHES, FWD_TC_LAUNCHES
    _check("flashattn_fwd", q, {"k": k, "v": v})
    o = torch.empty_like(q)  # q's strides when q is dense, else contiguous
    lse = torch.empty((q.shape[0], q.shape[1], q.shape[3]), dtype=torch.float32,
                      device=q.device)
    _launch("tfcgan_flashattn_fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                     lse.data_ptr()), (q, k, v, o), q, scale)
    FWD_LAUNCHES += 1
    FWD_TC_LAUNCHES += int(q.dtype == torch.bfloat16)
    return o, lse


def flashattn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                  lse: torch.Tensor, di: torch.Tensor, scale: float, need_q: bool = True,
                  need_k: bool = True, need_v: bool = True
                  ) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """(dq, dk, dv) of ``flashattn_fwd`` for the output gradient ``do`` (any
    strides), its saved ``lse`` and ``di[n, h, i] = sum_d o * do`` (float32);
    None for a gradient not asked for. dq launches one kernel, dk and dv share
    the other; in bfloat16 both are the tensor-core kernels."""
    global DQ_LAUNCHES, DKV_LAUNCHES, DQ_TC_LAUNCHES, DKV_TC_LAUNCHES
    _check("flashattn_bwd", q, {"k": k, "v": v, "do": do})
    _check_stat("flashattn_bwd", "lse", lse, q)
    _check_stat("flashattn_bwd", "di", di, q)
    dq = dk = dv = None
    tc = int(q.dtype == torch.bfloat16)
    if need_q:
        dq = torch.empty_like(q)
        _launch("tfcgan_flashattn_bwd_dq",
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 di.data_ptr(), dq.data_ptr()), (q, k, v, do, dq), q, scale)
        DQ_LAUNCHES += 1
        DQ_TC_LAUNCHES += tc
    if need_k or need_v:
        dk = torch.empty_like(k) if need_k else None
        dv = torch.empty_like(v) if need_v else None
        _launch("tfcgan_flashattn_bwd_dkv",
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 di.data_ptr(), _ptr(dk), _ptr(dv)), (q, k, v, do, dk, dv), q, scale)
        DKV_LAUNCHES += 1
        DKV_TC_LAUNCHES += tc
    return dq, dk, dv
