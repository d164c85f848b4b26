"""Multi-process runtime set-up, port of ``tfcgan_tpu.parallel.distributed``.

One process drives one card; the processes of a job form the
``torch.distributed`` world, the (data, spatial, tensor) grid of
``parallel.mesh``. Going multi-process changes two things, as in the JAX
package:

1. call :func:`initialize` once per process before the first collective
   (``cli train`` and ``cli test`` do so under ``torchrun``);
2. feed each process its own share of the global batch (``mesh.shard_batch``,
   or ``mesh.local_share``: by the data coordinate, so that the spatial and
   tensor ranks of a share get the same samples; on a spatial mesh each
   image's rows cut by the spatial coordinate, ``mesh.local_rows``).

The gradient mean is the trainer's (``train/trainer.py``), coalesced
all-reduces a phase: NCCL between cards, gloo on the host.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> None:
    """``torch.distributed.init_process_group`` for this process.

    With the arguments None it reads what ``torchrun`` sets: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; a
    ``coordinator_address`` ("host:port") and the two counts name them
    instead. The backend is NCCL where CUDA is available and gloo on the host,
    unless ``backend`` says otherwise; under NCCL this process's card is
    ``cuda:$LOCAL_RANK``. ``num_processes=1`` is the explicit no-op, as in
    JAX. Errors propagate: a job that silently fell back to one process would
    train N unsynchronised copies."""
    if num_processes == 1:
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kwargs = {}
    if backend == "nccl":
        device = local_device("nccl")
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, **kwargs)


def local_device(backend: str | None = None) -> torch.device:
    """This process's device: ``cuda:$LOCAL_RANK`` under NCCL, the host under
    gloo (the backend of the initialised group when ``backend`` is None)."""
    if backend is None:
        backend = dist.get_backend() if dist.is_initialized() else "gloo"
    if backend == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cpu")


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh_devices() -> list[torch.device]:
    """Every process's device, in rank order: the devices of the data axis."""
    mine = local_device()
    if not dist.is_initialized():
        return [mine]
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, str(mine))
    return [torch.device(d) for d in out]
