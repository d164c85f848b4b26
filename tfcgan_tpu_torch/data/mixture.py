"""Balanced multi-dataset mixture, the port's copy of ``tfcgan_tpu.data.mixture``.

The favtgan ED/EA trainers draw half a batch from each of two datasets, concat
and randperm-shuffle per step, refilling exhausted iterators mid-epoch
(``TFC-GAN-FFT/src/favtgan_..._TripTemp_ED.py:349-430``). Same semantics and
the same numpy draws here, on host batches, for any number of sources.
"""

from __future__ import annotations

import numpy as np


class BalancedMixture:
    """Yields batches with an equal share from each source iterator factory."""

    def __init__(self, dataset_factories, batch_size: int, seed: int = 42):
        assert batch_size % len(dataset_factories) == 0, (
            "batch_size must divide evenly across sources"
        )
        self.factories = list(dataset_factories)
        self.batch_size = batch_size
        self.share = batch_size // len(self.factories)
        self.rng = np.random.RandomState(seed)
        self.iters = [iter(f()) for f in self.factories]

    def _next_share(self, i):
        try:
            return next(self.iters[i])
        except StopIteration:
            # reference: catch StopIteration and re-seed the iterator (:403-409)
            self.iters[i] = iter(self.factories[i]())
            return next(self.iters[i])

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        shares = [self._next_share(i) for i in range(len(self.factories))]
        keys = shares[0].keys()
        merged = {
            k: np.concatenate([s[k][: self.share] for s in shares], axis=0)
            for k in keys
        }
        perm = self.rng.permutation(self.batch_size)
        return {k: v[perm] for k, v in merged.items()}
