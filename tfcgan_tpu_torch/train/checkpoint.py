"""Atomic full-state checkpoints of the port, after ``tfcgan_tpu.train.checkpoint``.

The format is the port's own: one checkpoint is a directory ``step_%08d``
holding ``state.pt`` (``torch.save``) with the whole ``TrainState``:

- ``step``;
- ``G`` and ``D``: the modules' ``state_dict``s (D's spectral u/v included);
- ``lpips``: the frozen LPIPS module's, or None (the JAX state's ``frozen``
  tree), so that a resume does not depend on the init seed;
- ``opt_g`` and ``opt_d``: the Adams' ``state_dict``s (``opt_d`` None without
  a discriminator);
- ``generator``: ``state.generator.get_state()``, of a CPU or a CUDA
  generator.

A save writes into a temporary directory beside the target and renames it
into place, so a checkpoint directory is whole or absent; a repeated save of
a step already on disk changes nothing. A JAX (Orbax) checkpoint reaches the
port only through ``tools/export_g_params.py`` and
``bridge.train_state_from_flax``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading

import torch

from tfcgan_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def _state_dict(state: TrainState) -> dict:
    return {"step": int(state.step), "G": state.G.state_dict(), "D": state.D.state_dict(),
            "lpips": None if state.lpips is None else state.lpips.state_dict(),
            "opt_g": state.opt_g.state_dict(),
            "opt_d": None if state.opt_d is None else state.opt_d.state_dict(),
            "generator": state.generator.get_state()}


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(path: str, snapshot: dict) -> None:
    """``snapshot`` into ``path``/state.pt through a temporary directory
    beside it; nothing is left behind when the write fails."""
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", dir=parent)
    try:
        torch.save(snapshot, os.path.join(tmp, STATE_FILE))
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    path = checkpoint_path(ckpt_dir, int(state.step))
    if os.path.isdir(path):  # idempotent: this step is already on disk
        return path
    _write(path, _to_host(_state_dict(state)))
    return path


def _load(path: str) -> dict:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Fill the built ``state`` (its modules, Adams and generator, on the
    recipe's device) in place from the checkpoint directory ``path``; returns it."""
    ckpt = _load(path)
    if (ckpt["lpips"] is None) != (state.lpips is None) or \
            (ckpt["opt_d"] is None) != (state.opt_d is None):
        raise ValueError(f"{path} holds the state of another recipe")
    state.G.load_state_dict(ckpt["G"])
    state.D.load_state_dict(ckpt["D"])
    if state.lpips is not None:
        state.lpips.load_state_dict(ckpt["lpips"])
    state.opt_g.load_state_dict(ckpt["opt_g"])
    if state.opt_d is not None:
        state.opt_d.load_state_dict(ckpt["opt_d"])
    state.generator.set_state(ckpt["generator"])
    state.step = int(ckpt["step"])
    return state


def load_generator_state(path: str) -> dict[str, torch.Tensor]:
    """The ``G`` state dict of a checkpoint, for the serve path's modules
    (``recipe.G`` and the serve path's modules have the same layout)."""
    return _load(path)["G"]


class AsyncCheckpointManager:
    """``save`` copies the state to host memory and returns; a background
    thread writes it. One save is in flight at a time: ``save`` first waits
    for the previous one, then skips a step already on disk. ``wait`` (and
    ``close``) returns once the write is done and re-raises its error."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, state: TrainState) -> str:
        path = checkpoint_path(self.ckpt_dir, int(state.step))
        self.wait()  # before isdir: the in-flight save commits first
        if os.path.isdir(path):  # idempotent: this step is already on disk
            return path
        snapshot = _to_host(_state_dict(state))
        self._thread = threading.Thread(target=self._write, args=(path, snapshot),
                                        name="checkpoint-write")
        self._thread.start()
        return path

    def _write(self, path: str, snapshot: dict) -> None:
        try:
            _write(path, snapshot)
        except Exception as e:  # surfaced by wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(os.path.abspath(ckpt_dir), steps[-1]) if steps else None
