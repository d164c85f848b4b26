"""Synthetic data without a dataset, port of ``tfcgan_tpu.data.synth``.

- ``synthetic_batch`` / ``synthetic_iterator``: smooth random pair batches.
- ``_face_scene`` / ``textured_face_scene``: procedural face-like scenes.
- ``synthetic_registration_batch`` / ``synthetic_registration_iterator``:
  visible/thermal face pairs with B misaligned by a random affine, and the
  affine and the aligned B as ground truth.
- ``synthetic_batch_device``: a ``synthetic_batch`` drawn on the device.
- ``face_pair`` / ``warp_affine_host``: the visible/thermal renderings of a
  face scene, and the host affine warp that misaligns B; the on-disk set of
  the end-to-end journeys and the family journeys' truth reuse them.

All but the last are numpy arrays from the same ``RandomState`` stream as the
JAX package's, so one seed gives both packages the same arrays bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tfcgan_tpu_torch.ops.temperature import TEMP_MAX_C, TEMP_MIN_C


def _temperatures(b: np.ndarray) -> np.ndarray:
    """T_B: the LUT over B's uint8 red channel."""
    red_u8 = np.round((b[..., 0] * 0.5 + 0.5) * 255.0)
    return (TEMP_MIN_C + red_u8 * (TEMP_MAX_C - TEMP_MIN_C) / 255.0).astype(np.float32)


def synthetic_batch(batch_size: int = 8, image_size: int = 64, channels: int = 3,
                    seed: int = 0, with_labels: bool = False,
                    num_classes: int = 4) -> dict[str, np.ndarray]:
    """Smooth random pair batch {"A", "B", "T_B"[, "LAB3", "LAB"]} in the
    trainer's input format: A/B (N, H, W, C) float32 in [-1, 1]."""
    rng = np.random.RandomState(seed)

    def smooth(n):
        x = rng.randn(n, image_size // 8, image_size // 8, channels).astype(np.float32)
        return np.tanh(x.repeat(8, axis=1).repeat(8, axis=2))

    a = smooth(batch_size)
    b = smooth(batch_size)
    batch = {"A": a, "B": b, "T_B": _temperatures(b)}
    if with_labels:
        lab3 = np.stack([
            rng.randint(0, 2, batch_size),
            rng.randint(0, num_classes, batch_size),
            rng.randint(0, 3, batch_size),
        ], axis=1).astype(np.int32)
        batch["LAB3"] = lab3
        batch["LAB"] = lab3[:, 1].copy()
    return batch


def synthetic_iterator(num_batches: int, **kw):
    for i in range(num_batches):
        yield synthetic_batch(seed=i, **kw)


def synthetic_batch_device(batch_size: int = 8, image_size: int = 64, channels: int = 3,
                           seed: int = 0, with_labels: bool = False, num_classes: int = 4,
                           device="cuda", generator: torch.Generator | None = None
                           ) -> dict[str, torch.Tensor]:
    """``synthetic_batch`` drawn on ``device`` from ``generator`` (default: a
    generator on ``device`` seeded with ``seed``), with no host-to-device
    copy. It has the host batch's distribution, not its values."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(seed)

    def smooth():
        x = torch.randn((batch_size, image_size // 8, image_size // 8, channels),
                        generator=generator, device=device)
        return torch.tanh(x.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2))

    a, b = smooth(), smooth()
    red_u8 = torch.round((b[..., 0] * 0.5 + 0.5) * 255.0)
    batch = {"A": a, "B": b, "T_B": TEMP_MIN_C + red_u8 * (TEMP_MAX_C - TEMP_MIN_C) / 255.0}
    if with_labels:
        def labels(high):
            return torch.randint(0, high, (batch_size,), generator=generator, device=device)

        lab3 = torch.stack([labels(2), labels(num_classes), labels(3)], dim=1).to(torch.int32)
        batch["LAB3"] = lab3
        batch["LAB"] = lab3[:, 1].clone()
    return batch


def _face_scene(rng: np.random.RandomState, n: int, size: int) -> np.ndarray:
    """Procedural face-like grayscale scenes in [0, 1], (N, H, W): a
    soft-edged head ellipse, eyes and mouth on a gradient background, with
    smooth falloffs so that registration metrics and morphological gradients
    carry signal at any resolution."""
    lin = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")

    def blob(cx, cy, rx, ry, sharp):
        # (N, 1, 1) parameters against (H, W) grids -> (N, H, W) soft masks
        d = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
        return 1.0 / (1.0 + np.exp(np.clip((d - 1.0) * sharp, -50.0, 50.0)))

    def col(lo, hi):
        return rng.uniform(lo, hi, (n, 1, 1)).astype(np.float32)

    head = blob(col(-0.08, 0.08), col(-0.08, 0.08), col(0.45, 0.6), col(0.6, 0.75), 8.0)
    eye_y = col(-0.3, -0.18)
    eye_dx = col(0.18, 0.28)
    eyes = blob(-eye_dx, eye_y, col(0.06, 0.1), col(0.04, 0.07), 14.0) + blob(
        eye_dx, eye_y, col(0.06, 0.1), col(0.04, 0.07), 14.0)
    mouth = blob(col(-0.05, 0.05), col(0.3, 0.45), col(0.15, 0.25), col(0.05, 0.09), 12.0)
    bg = 0.15 + 0.1 * (yy[None] * col(-1, 1) + xx[None] * col(-1, 1))
    scene = bg * (1 - head) + head * (0.65 + 0.1 * col(-1, 1)) - 0.35 * eyes - 0.25 * mouth
    return np.clip(scene, 0.0, 1.0)


def textured_face_scene(rng: np.random.RandomState, n: int, size: int,
                        texture_amp: float = 0.04) -> np.ndarray:
    """Face scenes with band-limited micro-texture, (N, H, W) in [0, 1]: the
    pristine domain of the synthetic-fitted NIQE model (blurring removes the
    texture, as it does a natural image's)."""
    from scipy import ndimage

    base = _face_scene(rng, n, size)
    tex = np.stack([ndimage.gaussian_filter(rng.randn(size, size), 0.7) for _ in range(n)])
    return np.clip(base + texture_amp * tex, 0.0, 1.0)


def face_pair(gray: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The visible and thermal renderings of float32 face scenes ``gray``
    ((..., H, W) in [0, 1]): visible in warm skin tones, thermal as the
    inverted intensity, red-heavy; each (..., H, W, 3) float32 in [-1, 1]."""
    a = np.stack([gray, gray * 0.82, gray * 0.70], axis=-1).astype(np.float32) * 2.0 - 1.0
    hot = 1.0 - gray
    b = np.stack([hot, hot * 0.55, hot * 0.35], axis=-1).astype(np.float32) * 2.0 - 1.0
    return a, b


def warp_affine_host(images: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """(N, H, W, C) images warped by the (N, 2, 3) affines ``theta``: torch's
    CPU ``affine_grid`` + bilinear ``grid_sample`` with border padding. Data
    preparation on the host, the same CPU call as the JAX package's, so that
    both give the same arrays (not the K3 path)."""
    src = torch.from_numpy(np.asarray(images)).permute(0, 3, 1, 2)
    grid = F.affine_grid(torch.from_numpy(theta), src.shape, align_corners=False)
    return (F.grid_sample(src, grid, mode="bilinear", padding_mode="border", align_corners=False)
            .permute(0, 2, 3, 1).numpy())


def synthetic_registration_batch(batch_size: int = 8, image_size: int = 64, seed: int = 0,
                                 max_translate: float = 0.12, max_rotate: float = 0.08
                                 ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Misaligned visible/thermal pairs with each sample's affine ground truth.

    A is a visible rendering of a face scene, B_aligned a thermal rendering of
    the same geometry, and B is B_aligned warped by a random affine theta
    (rotation up to +-``max_rotate`` rad, translation up to
    +-``max_translate`` in [-1, 1] grid units). Returns (batch, truth), truth
    holding ``B_aligned`` and the (N, 2, 3) ``theta``."""
    rng = np.random.RandomState(seed)
    a, b_aligned = face_pair(_face_scene(rng, batch_size, image_size))

    ang = rng.uniform(-max_rotate, max_rotate, batch_size).astype(np.float32)
    tx = rng.uniform(-max_translate, max_translate, batch_size).astype(np.float32)
    ty = rng.uniform(-max_translate, max_translate, batch_size).astype(np.float32)
    theta = np.zeros((batch_size, 2, 3), np.float32)
    theta[:, 0, 0] = np.cos(ang)
    theta[:, 0, 1] = -np.sin(ang)
    theta[:, 1, 0] = np.sin(ang)
    theta[:, 1, 1] = np.cos(ang)
    theta[:, 0, 2] = tx
    theta[:, 1, 2] = ty

    b = warp_affine_host(b_aligned, theta).astype(np.float32)

    batch = {"A": a, "B": b, "T_B": _temperatures(b)}
    return batch, {"B_aligned": b_aligned, "theta": theta}


def synthetic_registration_iterator(num_batches: int, **kw):
    for i in range(num_batches):
        yield synthetic_registration_batch(seed=i + 1, **kw)[0]
