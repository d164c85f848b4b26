"""Atomic full-state checkpoints of the port, after ``tfcgan_tpu.train.checkpoint``.

The format is the port's own: one checkpoint is a directory ``step_%08d``
holding ``state.pt`` (``torch.save``) with the whole ``TrainState``:

- ``step``;
- ``G`` and ``D``: the modules' ``state_dict``s (D's spectral u/v included);
- ``lpips`` and ``cnns``: the frozen LPIPS module's and the debiased
  V4-V7 regional CNNs' (backbones and heads), or None (the JAX state's
  ``frozen`` tree, and the heads of its ``g_params``), so that a resume does
  not depend on the init seed;
- ``frozen``: the recipe's other frozen modules (ThermalGAN's detached
  stage-1 discriminator), or None;
- ``extra``: the recipe-owned tensors (CycleGAN's replay buffers and their
  counts), or None;
- ``opt_g`` and ``opt_d``: the Adams' ``state_dict``s (``opt_d`` None without
  a discriminator; ``opt_g`` holds the V4-V6 heads' moments);
- ``generator``: ``state.generator.get_state()``, of a CPU or a CUDA
  generator.

A save writes into a temporary directory beside the target and renames it
into place, so a checkpoint directory is whole or absent; a repeated save of
a step already on disk changes nothing. In a data-parallel run (``mesh``)
the replicas are equal, so rank 0 writes, synchronously or asynchronously,
and every rank waits at a barrier after the save; every rank restores. The
format does not depend on the world size or the mesh: on a tensor mesh the
ranks of rank 0's tensor group gather every sharded parameter and both Adam
moments before rank 0 writes, so the file is the one an unsharded run
writes, and it restores into one process, a data mesh or a tensor mesh
(``restore_checkpoint`` into an unplaced state, then
``parallel.place_state``, which keeps each rank's slices). A JAX (Orbax) checkpoint reaches the
port only through ``tools/export_g_params.py`` and
``bridge.train_state_from_flax``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading

import torch
import torch.distributed as dist

from tfcgan_tpu_torch.parallel.tensor import full_optimizer_state_dict, full_state_dict
from tfcgan_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def _state_dict(state: TrainState) -> dict:
    """The whole state, sharded parameters and moments gathered (a collective
    over each tensor group that holds a slice)."""
    def sd(m):
        return None if m is None else full_state_dict(m)

    return {"step": int(state.step), "G": sd(state.G), "D": sd(state.D),
            "lpips": sd(state.lpips), "cnns": sd(state.cnns), "frozen": sd(state.frozen),
            "extra": state.extra,
            "opt_g": full_optimizer_state_dict(state.opt_g),
            "opt_d": None if state.opt_d is None else full_optimizer_state_dict(state.opt_d),
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


def _barrier(mesh) -> None:
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def _writes(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _gathers(mesh) -> bool:
    """Whether this rank takes part in the state's gathers: rank 0's tensor group."""
    return _writes(mesh) or (mesh.tensor is not None and mesh.leads_tensor_group)


def _snapshot(path: str, state: TrainState, mesh) -> dict | None:
    """The host copy of ``state`` that rank 0 writes to ``path``; None on
    the other ranks, and where the step is on disk already (a save is
    idempotent). On a tensor mesh the ranks of rank 0's tensor group take
    rank 0's decision and gather with it."""
    if not _gathers(mesh):
        return None
    skip = _writes(mesh) and os.path.isdir(path)
    if mesh is not None and mesh.tensor is not None:
        group = mesh.tensor.group
        flag = [skip]
        nccl = dist.get_backend(group) == "nccl"
        dist.broadcast_object_list(flag, dist.get_global_rank(group, 0), group=group,
                                   device=mesh.device if nccl else None)
        skip = flag[0]
    if skip:
        return None
    snapshot = _to_host(_state_dict(state))
    return snapshot if _writes(mesh) else None


def save_checkpoint(ckpt_dir: str, state: TrainState, mesh=None) -> str:
    """``state`` into ``ckpt_dir``/step_%08d (by rank 0 under ``mesh``;
    every rank calls it)."""
    path = checkpoint_path(ckpt_dir, int(state.step))
    snapshot = _snapshot(path, state, mesh)
    if snapshot is not None:
        _write(path, snapshot)
    _barrier(mesh)
    return path


def _load(path: str) -> dict:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def _copy_into(dst: dict, src: dict) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (the same nesting of
    dicts, the same shapes), in place on ``dst``'s device."""
    if set(dst) != set(src):
        raise ValueError(f"recipe state keys {sorted(dst)} != checkpoint's {sorted(src)}")
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        elif v.shape != src[k].shape:
            raise ValueError(f"recipe state {k!r}: shape {tuple(v.shape)} != checkpoint's "
                             f"{tuple(src[k].shape)}")
        else:
            v.copy_(src[k])


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Fill the built ``state`` (its modules, Adams and generator, on the
    recipe's device) in place from the checkpoint directory ``path``; returns it."""
    ckpt = _load(path)
    if (ckpt["lpips"] is None) != (state.lpips is None) or \
            (ckpt.get("cnns") is None) != (state.cnns is None) or \
            (ckpt.get("frozen") is None) != (state.frozen is None) or \
            (ckpt.get("extra") is None) != (state.extra is None) or \
            (ckpt["opt_d"] is None) != (state.opt_d is None):
        raise ValueError(f"{path} holds the state of another recipe")
    state.G.load_state_dict(ckpt["G"])
    state.D.load_state_dict(ckpt["D"])
    if state.lpips is not None:
        state.lpips.load_state_dict(ckpt["lpips"])
    if state.cnns is not None:
        state.cnns.load_state_dict(ckpt["cnns"])
    if state.frozen is not None:
        state.frozen.load_state_dict(ckpt["frozen"])
    if state.extra is not None:
        _copy_into(state.extra, ckpt["extra"])
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
    ``close``) returns once the write is done and re-raises its error. Under
    ``mesh`` every rank calls ``save``, rank 0 writes and the ranks meet at a
    barrier in ``wait``."""

    def __init__(self, ckpt_dir: str, mesh=None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.mesh = mesh
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, state: TrainState) -> str:
        path = checkpoint_path(self.ckpt_dir, int(state.step))
        self.wait()  # before isdir: the in-flight save commits first
        snapshot = _snapshot(path, state, self.mesh)
        if snapshot is None:
            return path
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
        """Under a mesh every rank calls it: rank 0's write ends before any
        rank passes the barrier."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier(self.mesh)
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
