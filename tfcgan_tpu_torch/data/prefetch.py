"""Threaded input pipeline, port of ``tfcgan_tpu.data.prefetch``.

- ``PrefetchLoader``: a thread pool assembling whole batches concurrently
  (PIL decode releases the GIL), yielded in ``pairs.batch_iterator``'s order
  whatever order they finish in; a worker's error is re-raised in the
  consumer. ``raw=True`` assembles uint8 items (``raw_item``).
- ``device_prefetch``: a lookahead thread that copies the next batches to the
  device while the current step runs. On a CUDA device each batch goes into
  pinned host memory and is copied with ``non_blocking=True`` on a side
  stream; an event recorded there is waited on by the consumer's stream
  before the batch is used; two batches ahead at most, a double buffer. With
  ``via_uint8`` the uint8 batches of ``PrefetchLoader(raw=True)`` cross
  (4x fewer bytes) and are normalised on the device (``pool.finish_uint8``,
  bit for bit the host path's values); class labels pass through as they are.
- ``is_device_batch``: ``Trainer.step`` uses such a batch as it is;
  ``stage_batch`` places any other (a host batch) on the device.

In a data-parallel run each rank's ``PrefetchLoader(mesh=...)`` shuffles with
the same seed and decodes only its share of each global batch (by its data
coordinate: the ranks of a tensor group decode the same share), and
``device_prefetch`` places that share on the rank's card (``mesh.device``),
as the JAX loader feeds each host its shard; on a spatial mesh the share
keeps only this rank's rows of each image (``parallel.local_rows``), so T_B,
made from B's rows on the device, is cut with them.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
from collections.abc import Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tfcgan_tpu_torch.data.pool import finish_uint8
from tfcgan_tpu_torch.parallel.mesh import local_rows, local_share


class PrefetchLoader:
    """Deterministic threaded batcher over an indexable dataset: the
    semantics of ``pairs.batch_iterator`` (seeded shuffle an epoch,
    ``drop_last``) with ``num_workers`` batches assembled concurrently.
    ``batch_size`` is the global batch; under ``mesh`` each batch holds only
    this rank's share of it."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, shuffle: bool = True,
                 seed: int = 42, drop_last: bool = True, epochs: int | None = None,
                 raw: bool = False, mesh=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epochs = epochs
        self.raw = raw
        self.mesh = mesh

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_batch(self, idxs: np.ndarray) -> dict[str, np.ndarray]:
        if self.mesh is not None:
            idxs = idxs[local_share(len(idxs), self.mesh)]
        get = self.dataset.raw_item if self.raw else self.dataset.__getitem__
        items = [get(int(j)) for j in idxs]
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        return {k: np.ascontiguousarray(v) for k, v in local_rows(batch, self.mesh).items()}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            epoch = 0
            while self.epochs is None or epoch < self.epochs:
                order = np.arange(len(self.dataset))
                if self.shuffle:
                    rng.shuffle(order)
                n_full = len(self)
                # num_workers + 2 batches in flight: bounded memory, workers ahead
                window = self.num_workers + 2
                futures = collections.deque()

                def submit(i):
                    futures.append(pool.submit(
                        self._load_batch, order[i * self.batch_size:(i + 1) * self.batch_size]))

                for i in range(min(window, n_full)):
                    submit(i)
                nxt = min(window, n_full)
                while futures:
                    yield futures.popleft().result()
                    if nxt < n_full:
                        submit(nxt)
                        nxt += 1
                epoch += 1


def is_device_batch(batch: dict, device) -> bool:
    """True when every value is a tensor on ``device`` (``cuda`` matches any
    card's tensor, ``cuda:1`` only that card's)."""
    device = torch.device(device)
    return all(isinstance(v, torch.Tensor) and v.device.type == device.type
               and device.index in (None, v.device.index) for v in batch.values())


def stage_batch(batch: dict, device) -> dict[str, torch.Tensor]:
    """A host batch on ``device`` as a step takes it: the images (A, B, T_B)
    float32 and the class labels (LAB, LAB3) int64, each contiguous; other
    keys are dropped."""
    images = {k: torch.as_tensor(v).to(device, torch.float32).contiguous()
              for k, v in batch.items() if k in ("A", "B", "T_B")}
    labels = {k: torch.as_tensor(v).to(device, torch.int64).contiguous()
              for k, v in batch.items() if k in ("LAB", "LAB3")}
    return {**images, **labels}


def device_prefetch(batches: Iterable[dict], device, via_uint8: bool = False
                    ) -> Iterator[dict[str, torch.Tensor]]:
    """Host batches -> batches on ``device``, copied up to 2 ahead of the
    consumer by a thread (a double buffer). Closing the iterator stops the
    thread (and closes ``batches``)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=2)
    done, stop, err = object(), threading.Event(), []

    def place(b: dict):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
        if not cuda:
            return {k: v.to(device) for k, v in host.items()}, None
        with torch.cuda.stream(side):
            placed = {k: v.pin_memory().to(device, non_blocking=True) for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(side)
        return placed, event

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def feeder():
        try:
            with torch.cuda.device(device) if cuda else contextlib.nullcontext():
                for b in batches:
                    if not put(place(b)):
                        break
        except Exception as e:  # surfaced in the consumer
            err.append(e)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
            put(done)

    thread = threading.Thread(target=feeder, daemon=True, name="device-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            placed, event = item
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for v in placed.values():  # allocated on the side stream, used on this one
                    v.record_stream(stream)
            if via_uint8:
                rest = {k: v for k, v in placed.items() if k not in ("A_u8", "B_u8")}
                placed = {**finish_uint8(placed["A_u8"], placed["B_u8"]), **rest}
            yield placed
    finally:
        stop.set()
        thread.join()
