"""Device meshes for multi-device runs on torch.distributed.

The codec shards along two mesh axes:
  - "data": the batch of images (no communication);
  - "tile": the spatial tiles of an image (width tiles or MB-row stripes),
    whose edges go to the neighbouring tile by point-to-point halo sends.

torch.distributed runs one process a device, so a mesh is a
``DeviceMesh`` over the ranks of the job, with dim names ("data", "tile"),
and a sharding is a DTensor placement tuple.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ..device import resolve_device


def make_mesh(n_devices: int | None = None, *, data: int | None = None,
              tile: int | None = None, device=None):
    """A (data, tile) ``DeviceMesh`` over the ranks of the job.

    Default split: as many tile shards as the largest power of two <=
    sqrt(n) that divides the rank count n, the rest data-parallel.
    ``device`` None means CUDA (and raises without it); the caller asks
    for "cpu".  Needs a process group (``distributed.initialize``); a mesh
    spans every rank of it, so ``n_devices``, if given, must be the world
    size.
    """
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.distributed.initialize() first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: a mesh spans every rank of the job "
                         f"({world}), not {n}")
    if data is None and tile is None:
        tile = 1 << int(math.log2(max(1, int(math.sqrt(n)))))
        while n % tile:
            tile //= 2
        data = n // tile
    elif data is None:
        data = n // tile
    elif tile is None:
        tile = n // data
    if data * tile != n:
        raise ValueError(f"mesh {data}x{tile} != {n} devices")
    return DeviceMesh(dev.type, torch.arange(n).reshape(data, tile),
                      mesh_dim_names=("data", "tile"))


def batch_sharding(mesh) -> tuple:
    """The placements that shard a (B, H, W) batch's leading axis over
    "data" and its width over "tile"."""
    return (Shard(0), Shard(2))


__all__ = ["batch_sharding", "make_mesh"]
