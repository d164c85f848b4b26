"""A reader of the converted weight files, flax's msgpack format, without
the ``msgpack`` package (the H100 machine has none).

``flax.serialization.to_bytes`` writes a msgpack map of maps whose leaves
are arrays as extension 1, a msgpack of ``(shape, dtype name, raw bytes)``,
and numpy scalars as extension 3 in the same form. ``read_flax_msgpack``
decodes that subset: maps, arrays, str, bin, integers, floats, bool and nil,
and the two extensions; arrays come back as numpy arrays (C order; a
bfloat16 leaf as a torch tensor, numpy has no such type). flax splits leaves
over 2**30 bytes into chunks (``__msgpack_chunked_array__``): the reader
refuses them, no LPIPS or ResNet-18 leaf comes near that size.

``check_state_dict`` holds a converted state dict to a module's structure,
as ``serialization.from_bytes(template, ...)`` holds the tree to its
template: a missing, an extra or a misshaped leaf raises ``ValueError``.
"""

from __future__ import annotations

import struct
from collections.abc import Mapping

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = memoryview(data), 0, what

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated msgpack (wanted {n} bytes at offset "
                             f"{self.pos} of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext 8/16/32
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"{self.what}: msgpack type byte 0x{b:02x} at offset {self.pos - 1} "
                         "is not one flax writes")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if CHUNKED in out:
            raise ValueError(f"{self.what}: a leaf over 2**30 bytes, stored in flax's chunked "
                             "form, which this reader does not take")
        return out

    def ext(self, code: int, n: int):
        body = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"{self.what}: msgpack extension {code} is not one flax writes "
                             "for arrays")
        inner = _Reader(body, self.what)
        shape, dtype, raw = inner.value()
        if inner.pos != len(body):
            raise ValueError(f"{self.what}: trailing bytes in an array's extension")
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        count = int(np.prod(shape)) if shape else 1
        if dtype == "bfloat16":
            arr = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
        else:
            arr = np.frombuffer(raw, dtype=np.dtype(dtype))
        if arr.shape[0] != count:
            raise ValueError(f"{self.what}: array of shape {tuple(shape)} {dtype} holds "
                             f"{len(raw)} bytes")
        arr = arr.reshape(tuple(shape))
        return arr[()] if code == EXT_NPSCALAR else arr


def read_flax_msgpack(path: str) -> dict:
    """The tree of a file that ``flax.serialization.to_bytes`` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data, path)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} bytes after the msgpack object")
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: a flax state is a msgpack map, got {type(tree).__name__}")
    return tree


def check_state_dict(got: Mapping[str, torch.Tensor], template: Mapping[str, torch.Tensor],
                     what: str) -> dict[str, torch.Tensor]:
    """``got`` if it has exactly ``template``'s keys and shapes, else ValueError."""
    missing = sorted(set(template) - set(got))
    extra = sorted(set(got) - set(template))
    shapes = sorted(k for k in set(got) & set(template)
                    if tuple(got[k].shape) != tuple(template[k].shape))
    if missing or extra or shapes:
        detail = [f"missing {missing}" if missing else "", f"extra {extra}" if extra else "",
                  "misshaped " + ", ".join(f"{k} {tuple(got[k].shape)} (want "
                                           f"{tuple(template[k].shape)})" for k in shapes)
                  if shapes else ""]
        raise ValueError(f"{what} does not fit the module: " + "; ".join(d for d in detail if d))
    return dict(got)
