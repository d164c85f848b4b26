"""Weights from the JAX package to the port.

``generator_from_flax`` turns the JAX ``params["G"]`` tree of
``GeneratorUNet`` (a nested dict, or a flat dict with "/"-joined keys as
``tools/export_g_params.py`` writes to ``g_params.npz``) into the state dict of
``tfcgan_tpu_torch.models.unet.GeneratorUNet``. Flax stores every conv kernel
as ``(kh, kw, in, out)``; torch wants ``(out, in, kh, kw)`` for a conv and
``(in, out, kh, kw)`` for a transposed conv (the up blocks' ``conv``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def flatten_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {"a/b/c": np.ndarray}; flat input passes through."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _generator_key(path: str) -> tuple[str, tuple[int, ...] | None]:
    """Flax path -> (torch state-dict key, axis order for np.transpose)."""
    parts = path.split("/")
    if len(parts) == 3 and parts[1] == "conv" and parts[2] == "kernel":
        if parts[0].startswith("down"):
            return f"{parts[0]}.conv.weight", (3, 2, 0, 1)
        if parts[0].startswith("up"):
            return f"{parts[0]}.conv.weight", (2, 3, 0, 1)
    if parts == ["final_conv", "kernel"]:
        return "final_conv.weight", (3, 2, 0, 1)
    if parts == ["final_conv", "bias"]:
        return "final_conv.bias", None
    raise KeyError(f"no GeneratorUNet parameter for flax path {path!r}")


def generator_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``GeneratorUNet`` params -> float32 state dict of the port's G."""
    state = {}
    for path, value in flatten_params(params).items():
        key, axes = _generator_key(path)
        arr = np.asarray(value, dtype=np.float32)
        if axes is not None:
            arr = arr.transpose(axes)
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def load_generator_npz(path: str) -> dict[str, torch.Tensor]:
    """``g_params.npz`` (from ``tools/export_g_params.py``) -> state dict."""
    with np.load(path) as npz:
        return generator_from_flax({k: npz[k] for k in npz.files})
