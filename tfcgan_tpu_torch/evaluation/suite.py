"""Metric suite and image I/O of the serve path, port of
``tfcgan_tpu.evaluation.suite``.

- ``pair_metrics``: PSNR / multichannel and gray SSIM / Bhattacharyya /
  FFT-magnitude MSE and MAE per pair, on whatever device the tensors are on.
- ``save_image_grid`` writes 8-bit RGB PNGs with a small stdlib encoder
  (``zlib`` + ``struct``), so the serve path needs no imaging library.
- ``crop_stack`` and ``evaluate_dirs`` read PNGs with PIL, imported where used.
"""

from __future__ import annotations

import csv
import os
import struct
import zlib
from collections.abc import Iterable

import numpy as np
import torch

from tfcgan_tpu_torch.ops import metrics
from tfcgan_tpu_torch.ops.quantize import rgb_to_luma_uint8


def pair_metrics(real_b: torch.Tensor, fake_b: torch.Tensor) -> dict[str, torch.Tensor]:
    """real_b/fake_b: (N, H, W, 3) in [-1, 1]. Returns per-image (N,) tensors."""
    real_b, fake_b = real_b.float(), fake_b.float()
    r255 = (real_b * 0.5 + 0.5) * 255.0
    f255 = (fake_b * 0.5 + 0.5) * 255.0
    gray_r = rgb_to_luma_uint8(real_b, mode="smooth")
    gray_f = rgb_to_luma_uint8(fake_b, mode="smooth")
    return {
        "psnr": metrics.psnr(r255, f255),
        "ssim": metrics.ssim(r255, f255),
        "ssim_gray": metrics.ssim(gray_r, gray_f),
        "bhatt": metrics.bhattacharyya(r255, f255),
        "fft_mag_mse": metrics.fft_mag_mse(real_b, fake_b),
        "fft_mag_mae": metrics.fft_mag_mae(real_b, fake_b),
    }


def to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip((x * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> 8-bit RGB PNG (no filtering, zlib level 6)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, truecolour
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def save_image_grid(images: Iterable[np.ndarray], path: str, axis: int = 0) -> None:
    """Save [-1, 1] HWC RGB images concatenated along H (axis=0) or W (axis=1)."""
    arr = np.concatenate([to_uint8(np.asarray(i)) for i in images], axis=axis)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, arr)


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def crop_stack(stack_path: str, out_dirs: list[str], num: int = 3) -> None:
    """Slice an N-image vertical stack into per-role directories
    (real_A/, fake_B/, real_B/ ...), keeping the file name."""
    img = _read_rgb(stack_path)
    h = img.shape[0] // num
    base = os.path.basename(stack_path)
    for i, d in enumerate(out_dirs[:num]):
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, base), np.ascontiguousarray(img[i * h:(i + 1) * h]))


def _load_dir(d: str) -> tuple[list[str], np.ndarray]:
    files = sorted(f for f in os.listdir(d) if f.lower().endswith((".png", ".jpg", ".jpeg")))
    return files, np.stack([_read_rgb(os.path.join(d, f)).astype(np.float32) for f in files])


def evaluate_dirs(fake_dir: str, real_dir: str, out_csv: str | None = None,
                  device="cpu") -> dict[str, list]:
    """Offline eval over two directories of PNGs, matched by sort order.
    Returns {"file": [...], metric: [...]} and writes it as CSV if asked."""
    files_f, fakes = _load_dir(fake_dir)
    files_r, reals = _load_dir(real_dir)
    if len(files_f) != len(files_r):
        raise ValueError(f"directory size mismatch: {len(files_f)} fake vs {len(files_r)} real")
    real = torch.from_numpy(reals / 127.5 - 1.0).float().to(device)
    fake = torch.from_numpy(fakes / 127.5 - 1.0).float().to(device)
    table = {"file": files_f}
    table.update({k: v.cpu().tolist() for k, v in pair_metrics(real, fake).items()})
    if out_csv:
        with open(out_csv, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(table)
            writer.writerows(zip(*table.values()))
    return table
