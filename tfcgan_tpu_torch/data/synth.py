"""Synthetic paired data, port of ``tfcgan_tpu.data.synth.synthetic_batch``.

numpy arrays from the same ``RandomState`` stream, so one seed gives the JAX
package and the port the same batch.
"""

from __future__ import annotations

import numpy as np

from tfcgan_tpu_torch.ops.temperature import TEMP_MAX_C, TEMP_MIN_C


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
    red_u8 = np.round((b[..., 0] * 0.5 + 0.5) * 255.0)
    t_b = (TEMP_MIN_C + red_u8 * (TEMP_MAX_C - TEMP_MIN_C) / 255.0).astype(np.float32)
    batch = {"A": a, "B": b, "T_B": t_b}
    if with_labels:
        lab3 = np.stack([
            rng.randint(0, 2, batch_size),
            rng.randint(0, num_classes, batch_size),
            rng.randint(0, 3, batch_size),
        ], axis=1).astype(np.int32)
        batch["LAB3"] = lab3
        batch["LAB"] = lab3[:, 1].copy()
    return batch
