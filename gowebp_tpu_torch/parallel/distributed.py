"""Process-group set-up and the job-wide mesh.

One process a device: ``initialize`` joins this process to the job's
process group (NCCL on CUDA, gloo on the CPU) and, on CUDA, selects the
rank's card; ``global_mesh`` builds the (data, tile) mesh over every rank.
Launch the processes with ``torchrun --nproc-per-node N`` (which sets the
rank, world size, local rank and coordinator in the environment) or pass
them here.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import make_mesh

_job = {}   # the device this process initialized with


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None) -> None:
    """Join the job's process group, once a process (later calls return
    while the group lives; after ``destroy_process_group`` a call joins
    anew).

    ``coordinator_address`` "host:port" (or "tcp://host:port") of rank 0;
    without it MASTER_ADDR/MASTER_PORT from the environment, or, in a
    one-process job, a free localhost port.  ``num_processes`` and
    ``process_id`` default to WORLD_SIZE and RANK (1 and 0 without them).
    ``device`` None means CUDA and raises without it; on CUDA the rank's
    card is its local rank (LOCAL_RANK, else ``process_id``) modulo the
    cards of the host, and the backend NCCL; on "cpu" gloo.
    """
    if _job and dist.is_initialized():
        return
    dev = resolve_device(device)
    n = int(num_processes if num_processes is not None
            else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    if coordinator_address is None:
        if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ['MASTER_PORT']}")
        elif n == 1:
            coordinator_address = f"localhost:{_free_port()}"
        else:
            raise ValueError("initialize: a job of several processes needs "
                             "coordinator_address (or MASTER_ADDR and "
                             "MASTER_PORT)")
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=coordinator_address,
                                world_size=n, rank=rank)
    _job["device"] = dev


def global_mesh(tile: int | None = None):
    """A (data, tile) mesh over every rank of the job, on the device
    ``initialize`` was given.

    Keep ``tile`` within one host's devices, so that halo sends stay on
    the host's links; the data axis spans hosts (it only sees
    independent images).  The default is min(local ranks, 4), halved
    until it divides the world size; the local ranks are LOCAL_WORLD_SIZE,
    else the host's CUDA cards (1 on the CPU).
    """
    if not _job or not dist.is_initialized():
        raise RuntimeError("global_mesh: call initialize() first")
    dev = _job["device"]
    n = dist.get_world_size()
    if tile is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or (
            torch.cuda.device_count() if dev.type == "cuda" else 1)
        tile = max(1, min(local, 4))
        while n % tile:
            tile //= 2
    return make_mesh(n, tile=tile, device=dev)


__all__ = ["global_mesh", "initialize"]
