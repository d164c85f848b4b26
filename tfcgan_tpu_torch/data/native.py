"""ctypes binding of the native pair decoder, port of ``tfcgan_tpu.data.native``.

``csrc/fastpair.cpp`` (a byte-for-byte copy of the JAX package's
``native/fastpair.cpp``) splits an A|B image, resizes both halves with
Pillow's bicubic weights in float64, normalises them to [-1, 1] and maps B's
red channel to Celsius, in one threaded pass. Pillow itself works in fixed
point and rounds and clips between its two passes, so a resized half can
differ from PIL's by a grey level, and by up to 22 where noise is upscaled.
``ops/kernels/_build.py`` builds it with g++ into ``tfcgan_tpu_torch/_build/``
at first use. The JAX loader decodes through it by default, and so does the
port's ``PairedImageDataset``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from tfcgan_tpu_torch.ops.kernels import _build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


@functools.cache
def load() -> ctypes.CDLL:
    """The built library (compiled on first use); raises ``RuntimeError``
    when g++ is missing or fails."""
    lib = _build.load_library("fastpair")
    lib.process_pair.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 _F32P, _F32P, _F32P]
    lib.process_pair.restype = None
    lib.process_pair_batch.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _F32P, _F32P, _F32P, ctypes.c_int]
    lib.process_pair_batch.restype = None
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _outputs(lead: tuple, out_size: int):
    return (np.empty((*lead, out_size, out_size, 3), np.float32),
            np.empty((*lead, out_size, out_size, 3), np.float32),
            np.empty((*lead, out_size, out_size), np.float32))


def process_pair(img_u8: np.ndarray, out_size: int = 256):
    """(H, W, 3) uint8 A|B image -> (A_norm, B_norm, T_B) float32 arrays."""
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or img.shape[1] < 2:
        raise ValueError(f"want an (H, W >= 2, 3) A|B image, got {img.shape}")
    h, w, _ = img.shape
    a, b, t = _outputs((), out_size)
    load().process_pair(img.ctypes.data_as(_U8P), h, w, out_size,
                        a.ctypes.data_as(_F32P), b.ctypes.data_as(_F32P),
                        t.ctypes.data_as(_F32P))
    return a, b, t


def process_pair_batch(imgs_u8: np.ndarray, out_size: int = 256, threads: int = 8):
    """(N, H, W, 3) uint8 stack of A|B images -> batched (A, B, T_B), the
    images spread over ``threads`` threads."""
    imgs = np.ascontiguousarray(imgs_u8, dtype=np.uint8)
    if imgs.ndim != 4 or imgs.shape[3] != 3 or imgs.shape[2] < 2:
        raise ValueError(f"want an (N, H, W >= 2, 3) stack of A|B images, got {imgs.shape}")
    n, h, w, _ = imgs.shape
    a, b, t = _outputs((n,), out_size)
    load().process_pair_batch(imgs.ctypes.data_as(_U8P), n, h, w, out_size,
                              a.ctypes.data_as(_F32P), b.ctypes.data_as(_F32P),
                              t.ctypes.data_as(_F32P), threads)
    return a, b, t
