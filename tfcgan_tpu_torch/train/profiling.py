"""Profiling hooks, port of ``tfcgan_tpu.train.profiling``.

- ``trace``: a ``torch.profiler`` context writing a TensorBoard-loadable
  trace of the steps run inside it.
- ``StepTimer``: images/s over ticks, synchronising the card first.
- ``count_params``: the parameter count of a module.
- ``device_memory_summary`` / ``print_memory_summary``: the CUDA caching
  allocator's counters, ``{}`` on the CPU.

``assert_finite`` lives in ``train/trainer.py``.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StepTimer:
    """Images/s since the first ``tick``; each tick waits for the card when
    ``device`` is a CUDA device."""

    def __init__(self, batch_size: int, device="cpu"):
        self.batch_size = batch_size
        self.device = torch.device(device)
        self._t0 = None
        self._steps = 0

    def tick(self) -> float | None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return None
        self._steps += 1
        return self._steps * self.batch_size / (now - self._t0)


def count_params(module: torch.nn.Module) -> int:
    """Total parameter count (the reference's ``print_network``)."""
    return sum(p.numel() for p in module.parameters())


def device_memory_summary(device=None) -> dict:
    """The caching allocator's bytes in use, their peak and the card's
    memory, under the JAX package's keys; {} on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory)}


def print_memory_summary(prefix: str = "", device=None) -> None:
    s = device_memory_summary(device)
    if not s:
        print(f"{prefix}no device memory stats on this platform")
        return
    print(f"{prefix}device memory: {s['bytes_in_use'] / 1e9:.2f} GB in use / "
          f"{s['bytes_limit'] / 1e9:.2f} GB limit (peak {s['peak_bytes_in_use'] / 1e9:.2f} GB)")
