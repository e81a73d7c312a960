"""Multi-process set-up over ``torch.distributed``.

Port of ``parallel/distributed.py``. One process per device: NCCL between
CUDA devices, gloo between CPU processes. ``torchrun --nproc_per_node N``
(or the ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT`` environment it sets) starts the processes;
``initialize()`` joins them.

    from neuralgaussiansplatting_torch.parallel import distributed
    device = distributed.initialize()     # reads torchrun's environment
    mesh = distributed.make_global_mesh(n_tile=1)

Every process runs the same program; ``process_local_batch_slice`` gives
each its share of a camera batch, ``host_broadcast_pytree`` and
``assert_synchronized`` keep host-side decisions the same on every rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from neuralgaussiansplatting_torch import resolve_device
from neuralgaussiansplatting_torch.parallel import mesh as mesh_lib
from neuralgaussiansplatting_torch.parallel.mesh import rank, world_size


def local_device(platform: str = "cuda") -> torch.device:
    """This process's device: ``cuda:<LOCAL_RANK>`` (LOCAL_RANK 0 when
    unset), or the CPU when ``platform`` is "cpu"."""
    if platform == "cpu":
        return torch.device("cpu")
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device=None) -> torch.device:
    """Join the process group and return this process's device (``device``,
    default ``local_device()``; made current when it is a CUDA device).

    A no-op when a group exists already, or when nothing asks for more
    than one process (no arguments and ``WORLD_SIZE`` unset or 1). An
    explicit request (``init_method`` or ``world_size``) and a torchrun
    environment both fail loudly: a swallowed error would quietly train on
    one process. The backend is NCCL for a CUDA device, gloo for the CPU."""
    dev = torch.device(device) if device is not None else local_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    explicit = init_method is not None or world_size is not None
    if not explicit and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return dev
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return dev


def make_global_mesh(n_tile: int = 1, device=None) -> mesh_lib.Mesh:
    """(data, tile) mesh over every rank of the world; ``n_tile`` must divide
    the world size."""
    if world_size() % n_tile:
        raise ValueError(f"n_tile {n_tile} does not divide the world size "
                         f"{world_size()}")
    return mesh_lib.make_mesh(world_size() // n_tile, n_tile, device=device)


def process_local_batch_slice(global_batch: int):
    """(start, size) of this process's slice of a global camera batch."""
    per = global_batch // world_size()
    return rank() * per, per


def host_broadcast_pytree(tree, root: int = 0):
    """``tree`` (any picklable value) as rank ``root`` holds it, on every
    rank: agree on a host-side decision before acting on it."""
    if world_size() == 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def assert_synchronized(value):
    """Debug guard: raise unless every rank holds the same ``value`` (a
    host-side decision, e.g. a capacity or an alive count)."""
    if world_size() == 1:
        return
    seen = [None] * world_size()
    dist.all_gather_object(seen, value)
    if any(v != value for v in seen):
        raise RuntimeError(f"host-divergent value: {seen}")
