"""Device-resident training pool, port of ``tfcgan_tpu.data.pool``.

``DevicePool`` decodes the whole set once (``raw_item``) and keeps it in
device memory as uint8, 4x smaller than float32; each step gathers its batch
there and ``finish_uint8`` normalises it and applies the temperature map on
the device: no decode and no transfer but the batch's indices in steady
state. ``index_batches`` gives ``pairs.batch_iterator``'s order (a seeded
``RandomState`` shuffle an epoch, ``drop_last``).

The values equal ``batch_iterator``'s bit for bit: ``finish_uint8`` computes
the host formulas, (u8 / 255 - 0.5) / 0.5 and TEMP_MIN_C + B_u8[..., 0] *
((TEMP_MAX_C - TEMP_MIN_C) / 255), one float32 operation at a time, each
correctly rounded as numpy rounds it. The divisor 255 is a 0-dim tensor on
the device: divided by a Python number, CUDA tensors are multiplied by the
float32 reciprocal instead, which misses the quotient by 1 ulp for 126 of
the 256 values.

The JAX pool's assembly runs inside the jitted train step; eager PyTorch has
no program to fuse the gather into, so ``Trainer.fit(pool=...)`` calls
``batch`` before each step.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from tfcgan_tpu_torch.ops.temperature import TEMP_MAX_C, TEMP_MIN_C


def finish_uint8(a_u8: torch.Tensor, b_u8: torch.Tensor) -> dict[str, torch.Tensor]:
    """uint8 (N, H, W, 3) A and B -> {"A", "B", "T_B"} float32 on their device,
    equal to the host path's (``pairs._normalize`` and the temperature map)."""
    d255 = torch.tensor(255.0, device=a_u8.device)

    def norm(u):
        return (u.float() / d255 - 0.5) / 0.5

    t_b = TEMP_MIN_C + b_u8[..., 0].float() * ((TEMP_MAX_C - TEMP_MIN_C) / 255.0)
    return {"A": norm(a_u8), "B": norm(b_u8), "T_B": t_b}


def _decode_all(dataset, log_every: int = 0) -> dict[str, np.ndarray]:
    """One decode pass over ``dataset`` -> stacked uint8 arrays."""
    items = []
    for i in range(len(dataset)):
        items.append(dataset.raw_item(i))
        if log_every and (i + 1) % log_every == 0:
            print(f"pool decode {i + 1}/{len(dataset)}")
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class DevicePool:
    """The decoded set (``dataset.raw_item`` of every pair) as uint8 tensors
    on ``device``, with on-device batch assembly."""

    def __init__(self, dataset, device="cuda", log_every: int = 0):
        host = _decode_all(dataset, log_every)
        self.device = torch.device(device)
        self.arrays = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        self.n = int(host["A_u8"].shape[0])

    def batch(self, idx) -> dict[str, torch.Tensor]:
        """The batch of the integer indices ``idx``, assembled on the device."""
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64).to(self.device)
        return finish_uint8(self.arrays["A_u8"].index_select(0, idx),
                            self.arrays["B_u8"].index_select(0, idx))

    def index_batches(self, batch_size: int, seed: int = 42, epochs: int | None = None
                      ) -> Iterator[np.ndarray]:
        """Index arrays in ``pairs.batch_iterator``'s order, for
        ``Trainer.fit(..., pool=this)``."""
        rng = np.random.RandomState(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(self.n)
            rng.shuffle(order)
            for i in range(self.n // batch_size):
                yield order[i * batch_size:(i + 1) * batch_size]
            epoch += 1

    def steps_per_epoch(self, batch_size: int) -> int:
        return self.n // batch_size
