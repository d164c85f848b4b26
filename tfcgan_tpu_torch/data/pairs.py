"""Paired side-by-side image dataset, port of ``tfcgan_tpu.data.pairs``.

Each file holds A|B side by side; it is split at w/2 and bicubic-resized.
PIL reads the file; it is imported where an image is read (the package
imports without it). ``cache=True`` (or ``enable_cache()``) keeps the decoded
uint8 pairs in RAM, so epochs after the first skip the decode; ``raw_item`` gives the uint8
pair before normalisation, the input of the device-side paths
(``data/pool.DevicePool``, ``data/prefetch.device_prefetch(via_uint8=True)``).

Decoding, as in the JAX dataset: with ``use_native=True`` (the default) the
split, resize, normalisation and temperature map run in the C++ decoder
(``data/native.py``, built with g++ at first use; a failed build raises).
It resizes with Pillow's bicubic weights in float64, where Pillow works in
fixed point and rounds between its passes: a pair that needs a resize comes
out a grey level (up to 22 on upscaled noise) from the PIL path
(``use_native=False``), and bit for bit as the JAX default.
``__getitem__`` of an ``AtoB`` dataset without a cache takes the decoder's
floats; everything else (``raw_item``, ``BtoA``, the cache, so the device
pool and the uint8 stream) takes its output turned back into uint8 with
``np.rint``, which is exact.

Class labels: ``labels`` maps a file's basename to an int (``LAB``) or to a
(gender, ethnicity, age) triple (``LAB3``, int32, and ``LAB`` = its
ethnicity), as ``load_annotations_csv`` reads them; a file the map lacks
gets the label 0, as in the JAX loader, and so no ``LAB3``.

Batches: {"A": (N,H,W,3) float32 in [-1,1], "B": same, "T_B": (N,H,W) float32
Celsius[, "LAB": (N,) int32][, "LAB3": (N, 3) int32]}.

``UnpairedImageDataset`` is CycleGAN's loader of two unaligned directories
(the JAX CLI, like this one, trains every family on the paired files).
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np

from tfcgan_tpu_torch.evaluation.suite import _read_rgb
from tfcgan_tpu_torch.ops.temperature import TEMP_MAX_C, TEMP_MIN_C


def load_pair(path: str, image_size: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """One A|B image -> (A_u8, B_u8), each (H, W, 3) uint8."""
    from PIL import Image

    with Image.open(path) as f:
        img = f.convert("RGB")
    w, h = img.size
    size = (image_size, image_size)
    a = img.crop((0, 0, w / 2, h)).resize(size, Image.Resampling.BICUBIC)
    b = img.crop((w / 2, 0, w, h)).resize(size, Image.Resampling.BICUBIC)
    return np.asarray(a, dtype=np.uint8), np.asarray(b, dtype=np.uint8)


def _normalize(u8: np.ndarray) -> np.ndarray:
    # ToTensor + Normalize(0.5, 0.5): uint8/255 -> [-1, 1]
    return (u8.astype(np.float32) / 255.0 - 0.5) / 0.5


def _to_u8(x: np.ndarray) -> np.ndarray:
    """The inverse of ``_normalize`` on its outputs."""
    return np.rint((x * 0.5 + 0.5) * 255.0).astype(np.uint8)


class PairedImageDataset:
    """File-list dataset over a ``root/mode`` directory of A|B pair images."""

    def __init__(self, root: str, mode: str = "train", image_size: int = 256,
                 direction: str = "AtoB", labels: dict | None = None,
                 use_native: bool = True, cache: bool = False):
        self.files = sorted(glob.glob(os.path.join(root, mode, "*.*")))
        if not self.files:
            raise FileNotFoundError(f"no images under {os.path.join(root, mode)}")
        self.image_size = image_size
        self.direction = direction
        self.labels = labels
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] | None = {} if cache else None
        self._native = None
        if use_native:
            from tfcgan_tpu_torch.data import native

            try:
                native.load()
            except (RuntimeError, OSError) as e:
                raise RuntimeError("the native pair decoder did not build or load; pass "
                                   "use_native=False to decode with PIL") from e
            self._native = native

    def __len__(self) -> int:
        return len(self.files)

    def enable_cache(self) -> None:
        """Keep decoded pairs in RAM from now on (the CLI turns it on once it
        has sized the dataset)."""
        if self._cache is None:
            self._cache = {}

    def _raw_pair(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """Decoded (A_u8, B_u8) after the direction swap; cached when on."""
        idx = idx % len(self.files)
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        if self._native is not None:
            # the decoder's floats back to uint8: (u8 / 255 - .5) / .5 inverts exactly
            a, b, _ = self._native.process_pair(_read_rgb(self.files[idx]), self.image_size)
            a_u8, b_u8 = _to_u8(a), _to_u8(b)
        else:
            a_u8, b_u8 = load_pair(self.files[idx], self.image_size)
        if self.direction == "BtoA":
            a_u8, b_u8 = b_u8, a_u8
        if self._cache is not None:
            self._cache[idx] = (a_u8, b_u8)
        return a_u8, b_u8

    def _label_fields(self, idx: int) -> dict[str, np.ndarray]:
        if self.labels is None:
            return {}
        lab = self.labels.get(os.path.basename(self.files[idx % len(self.files)]), 0)
        if isinstance(lab, (tuple, list, np.ndarray)):  # (gender, ethnicity, age)
            lab3 = np.asarray(lab, np.int32)
            return {"LAB3": lab3, "LAB": np.int32(lab3[1])}
        return {"LAB": np.int32(lab)}

    def raw_item(self, idx: int) -> dict[str, np.ndarray]:
        """uint8 item {"A_u8", "B_u8"[, labels]}: normalisation and the
        temperature map are applied on the device (``data/pool.finish_uint8``)."""
        a_u8, b_u8 = self._raw_pair(idx)
        return {"A_u8": a_u8, "B_u8": b_u8, **self._label_fields(idx)}

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        if self._native is not None and self.direction == "AtoB" and self._cache is None:
            a, b, t_b = self._native.process_pair(
                _read_rgb(self.files[idx % len(self.files)]), self.image_size)
            return {"A": a, "B": b, "T_B": t_b, **self._label_fields(idx)}
        a_u8, b_u8 = self._raw_pair(idx)
        t_b = TEMP_MIN_C + b_u8[..., 0].astype(np.float32) * ((TEMP_MAX_C - TEMP_MIN_C) / 255.0)
        return {"A": _normalize(a_u8), "B": _normalize(b_u8), "T_B": t_b,
                **self._label_fields(idx)}


def batch_iterator(dataset, batch_size: int, shuffle: bool = True, seed: int = 42,
                   drop_last: bool = True, epochs: int | None = None):
    """Host-side batcher; the same order as the JAX package for one seed."""
    rng = np.random.RandomState(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(order)
        n_full = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
        for i in range(n_full):
            items = [dataset[int(j)] for j in order[i * batch_size:(i + 1) * batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
        epoch += 1


class UnpairedImageDataset:
    """CycleGAN's unpaired loader: ``root/{mode}A`` and ``root/{mode}B``
    directories, each image bicubic-resized with PIL; with ``unaligned`` B
    comes from a random index of a ``np.random.RandomState(seed)`` stream,
    one draw an item, as in the JAX loader. Items {"A", "B": (H, W, 3)
    float32 in [-1, 1], "T_B": (H, W) Celsius from B's red channel as a
    float}."""

    def __init__(self, root: str, mode: str = "train", image_size: int = 256,
                 unaligned: bool = True, seed: int = 42):
        self.files_a = sorted(glob.glob(os.path.join(root, f"{mode}A", "*.*")))
        self.files_b = sorted(glob.glob(os.path.join(root, f"{mode}B", "*.*")))
        if not self.files_a or not self.files_b:
            raise FileNotFoundError(f"no images under {root}/{mode}A|B")
        self.image_size = image_size
        self.unaligned = unaligned
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.files_a)

    def _load(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as f:
            img = f.convert("RGB").resize((self.image_size, self.image_size),
                                          Image.Resampling.BICUBIC)
        return _normalize(np.asarray(img, np.uint8))

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        a = self._load(self.files_a[idx % len(self.files_a)])
        j = self.rng.randint(0, len(self.files_b)) if self.unaligned else idx % len(self.files_b)
        b = self._load(self.files_b[j])
        t_b = TEMP_MIN_C + ((b[..., 0] * 0.5 + 0.5) * 255.0) * ((TEMP_MAX_C - TEMP_MIN_C) / 255.0)
        return {"A": a, "B": b, "T_B": t_b.astype(np.float32)}


def load_annotations_csv(path: str, file_col: int = 0, label_col: int = 2,
                         label_cols: tuple[int, int, int] | None = None) -> dict:
    """The annotations CSV of the debiased family -> {basename: int label},
    or {basename: (gender, ethnicity, age)} with ``label_cols`` (the CLI's
    (1, 2, 3): columns file, gender, ethnicity, age). As the JAX function
    reads it with pandas: the first row is the header, columns are taken by
    position, keys are the file column's basenames, labels go through int."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))[1:]
    rows = [r for r in rows if r]  # pandas skips blank lines
    if label_cols is not None:
        return {os.path.basename(r[file_col]): tuple(_int(r[c]) for c in label_cols)
                for r in rows}
    return {os.path.basename(r[file_col]): _int(r[label_col]) for r in rows}


def _int(cell: str) -> int:
    """pandas' ``astype(int)`` of a cell: an integer, or a float truncated."""
    try:
        return int(cell)
    except ValueError:
        return int(float(cell))
