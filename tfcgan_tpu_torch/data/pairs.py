"""Paired side-by-side image dataset, port of ``tfcgan_tpu.data.pairs``.

Each file holds A|B side by side; it is split at w/2 and bicubic-resized with
PIL, which is imported where an image is read (the package imports without
it). ``cache=True`` (or ``enable_cache()``) keeps the decoded uint8 pairs in
RAM, so epochs after the first skip the decode; ``raw_item`` gives the uint8
pair before normalisation, the input of the device-side paths
(``data/pool.DevicePool``, ``data/prefetch.device_prefetch(via_uint8=True)``).

The JAX dataset's ``use_native`` switch (its C++ decoder, which gives the PIL
path's bits) is not taken: the port has no native decoder yet, and the PIL
path is the one both packages share. Class labels (``labels``, ``LAB3``) wait
for the conditional recipes.

Batches: {"A": (N,H,W,3) float32 in [-1,1], "B": same, "T_B": (N,H,W) float32
Celsius}.
"""

from __future__ import annotations

import glob
import os

import numpy as np

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


class PairedImageDataset:
    """File-list dataset over a ``root/mode`` directory of A|B pair images."""

    def __init__(self, root: str, mode: str = "train", image_size: int = 256,
                 direction: str = "AtoB", cache: bool = False):
        self.files = sorted(glob.glob(os.path.join(root, mode, "*.*")))
        if not self.files:
            raise FileNotFoundError(f"no images under {os.path.join(root, mode)}")
        self.image_size = image_size
        self.direction = direction
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] | None = {} if cache else None

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
        a_u8, b_u8 = load_pair(self.files[idx], self.image_size)
        if self.direction == "BtoA":
            a_u8, b_u8 = b_u8, a_u8
        if self._cache is not None:
            self._cache[idx] = (a_u8, b_u8)
        return a_u8, b_u8

    def raw_item(self, idx: int) -> dict[str, np.ndarray]:
        """uint8 item {"A_u8", "B_u8"}: normalisation and the temperature map
        are applied on the device (``data/pool.finish_uint8``)."""
        a_u8, b_u8 = self._raw_pair(idx)
        return {"A_u8": a_u8, "B_u8": b_u8}

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        a_u8, b_u8 = self._raw_pair(idx)
        t_b = TEMP_MIN_C + b_u8[..., 0].astype(np.float32) * ((TEMP_MAX_C - TEMP_MIN_C) / 255.0)
        return {"A": _normalize(a_u8), "B": _normalize(b_u8), "T_B": t_b}


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
