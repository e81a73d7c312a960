"""A (data, tile) layout of the ranks of a ``torch.distributed`` world.

Port of ``parallel/mesh.py``. Axes:

- ``data``: the cameras of a step's batch (data parallelism). Every rank
  holds a replica of the Gaussians and of the optimizer state; the
  gradients are summed over this axis.
- ``tile``: the horizontal strips of one frame (strip parallelism), each
  rendered by its rank and gathered into the frame.

Rank r sits at data index r // n_tile and tile index r % n_tile. A
process-group is made (``dist.new_group``, called by every rank in the same
order) only for an axis that holds more than one rank but not the whole
world; an axis that is the whole world uses the default group, and one of
a single rank needs no collective. Without a process group (one process,
nothing initialised) the mesh is 1 x 1 and no collective runs.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from neuralgaussiansplatting_torch import resolve_device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on an ``n_data`` x ``n_tile`` grid of ranks and its
    device. ``data_group`` / ``tile_group``: the group that reduces or
    gathers over the axis (``dist.group.WORLD`` when the axis is the whole
    world), or None where the axis needs no collective."""

    n_data: int
    n_tile: int
    device: torch.device
    data_group: object = None
    tile_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "tile": self.n_tile}

    @property
    def data_index(self) -> int:
        return rank() // self.n_tile

    @property
    def tile_index(self) -> int:
        return rank() % self.n_tile


def _axis_group(size: int, ranks_of):
    """The group of this rank along an axis of ``size`` ranks; ``ranks_of(k)``
    lists the k-th group's ranks (every group is made, on every rank)."""
    world = world_size()
    if not dist.is_initialized() or (size == 1 and world > 1):
        return None
    if size == world:
        return dist.group.WORLD
    mine = None
    for k in range(world // size):
        ranks = ranks_of(k)
        group = dist.new_group(ranks)
        if rank() in ranks:
            mine = group
    return mine


def make_mesh(n_data: int | None = None, n_tile: int = 1,
              device=None) -> Mesh:
    """The (``n_data``, ``n_tile``) mesh of the world's ranks (``n_data``
    defaults to world / ``n_tile``; their product must be the world size).
    ``device``: this rank's device (default "cuda", the current CUDA
    device, which ``distributed.initialize`` sets per rank)."""
    world = world_size()
    if n_data is None:
        n_data = world // n_tile
    if n_data * n_tile != world:
        raise ValueError(f"a {n_data} x {n_tile} mesh needs {n_data * n_tile} "
                         f"ranks; the world has {world}")
    dev = resolve_device(device if device is not None else "cuda")
    data_group = _axis_group(
        n_data, lambda t: [d * n_tile + t for d in range(n_data)])
    tile_group = _axis_group(
        n_tile, lambda d: [d * n_tile + t for t in range(n_tile)])
    return Mesh(n_data, n_tile, dev, data_group, tile_group)


def replicated(mesh: Mesh, tensors):
    """Make ``tensors`` (an iterable of tensors on ``mesh.device``) the same
    on every rank: each is broadcast in place from rank 0. Returns them."""
    tensors = list(tensors)
    if dist.is_initialized() and world_size() > 1:
        for t in tensors:
            dist.broadcast(t, src=0)
    return tensors


def batch_sharded(mesh: Mesh, batch: int) -> slice:
    """This rank's slice of the leading (camera) axis of a global batch of
    ``batch``, split evenly over the data axis."""
    if batch % mesh.n_data:
        raise ValueError(f"a batch of {batch} cameras does not split over "
                         f"{mesh.n_data} data ranks")
    per = batch // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)
