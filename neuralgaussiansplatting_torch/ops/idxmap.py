"""Per-pixel hard z-buffer ("idxmap") and feature map for the neural path.

Port of ``ops/idxmap.py`` (the fork's ``rasterizer2`` GETMAP): every
Gaussian is a point whose pixel footprint is a square of radius S / z
(S = 3); it is culled when its view z <= 0.2 or its centre pixel is off
screen. Each pixel takes the nearest covering Gaussian (equal depths: the
lower id), and the feature map holds, per pixel, [depth, the sin/cos
positional encoding of the normalised view direction (4 frequencies x 3
dims, dim-major), the winner's feature_vector[25..63]]; colmap is the view
direction, depthmap the depth, idxmap the winner id (-1 on a miss).

Two z-buffers with one contract: ``backend="tiled"`` (32x32 tile binning and
kernel K3, ``ops/zbuffer_pallas.py``) and ``backend="xla"``, the per-pixel
sort oracle ``compute_idxmap``. Gradients reach ``features`` alone, through
the winner-row gather, whose backward is an exact per-Gaussian sum in a
fixed order (no atomics). Geometry enters detached, as the reference
returns zero geometry gradients.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from neuralgaussiansplatting_torch.ops.blend import sum_rows_by_id
from neuralgaussiansplatting_torch.ops.preprocess import CameraParams
from neuralgaussiansplatting_torch.ops.zbuffer_pallas import (  # noqa: F401
    POINT_SIZE, compute_idxmap_tiled, point_footprints,   # POINT_SIZE: S
)

NUM_FEATURES = 64          # rasterizer2 config.h:3
NUM_FREQUENCIES = 4        # rasterizer2 auxiliary.h:33
PE_DIMS = 24               # rasterizer2 auxiliary.h:34


class IdxMaps(NamedTuple):
    idxmap: torch.Tensor      # (H, W) int32, -1 = miss
    colmap: torch.Tensor      # (H, W, 3) view directions
    depthmap: torch.Tensor    # (H, W)
    featuremap: torch.Tensor  # (H, W, 64)
    num_inst: torch.Tensor    # () int32 demand; above ``capacity`` winners
                              # may be wrong: grow ``capacity``


def positional_encoding_3d(dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 24): sin/cos of 2^f * pi * x, dim-major
    [dim][freq][sin, cos] (rasterizer_impl.cu:26-42)."""
    freqs = (2.0 ** torch.arange(NUM_FREQUENCIES, dtype=torch.float32,
                                 device=dirs.device)) * math.pi
    scaled = dirs[..., :, None] * freqs                      # (..., 3, 4)
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-1)
    return enc.reshape(dirs.shape[:-1] + (PE_DIMS,))


def compute_idxmap(means3d: torch.Tensor, cam: CameraParams, capacity: int,
                   alive: torch.Tensor | None = None):
    """Closest Gaussian of every pixel by a per-pixel sort: the oracle.

    Every point is expanded into one instance per covered pixel (instance
    slots in ascending Gaussian order, truncated at ``capacity``), the
    instances are sorted stably on one int64 key pixel << 32 | depth bits
    (kept depths are positive, so their bits order like the floats), and
    each pixel takes the first instance of its run: equal depths go to the
    lower id. Returns (idx (H*W,) int32 with -1 on a miss, depth (N,),
    num_inst () the pixel-instance demand; above ``capacity`` the instances
    of the highest ids were dropped and winners may be wrong).
    """
    means3d = means3d.detach()
    n = means3d.shape[0]
    w, h = cam.width, cam.height
    dev = means3d.device
    depth, x0, y0, x1, y1, valid = point_footprints(means3d, cam)
    if alive is not None:
        valid = valid & alive
    x0, y0, x1, y1 = (a.long() for a in (x0, y0, x1, y1))
    touched = torch.where(valid, (x1 - x0) * (y1 - y0), 0)
    offsets = torch.cumsum(touched, 0)
    num_inst = offsets[-1]
    starts = offsets - touched

    slots = torch.arange(capacity, device=dev)
    # owner of slot s: the first Gaussian whose run ends after s
    gid = torch.clamp_max(torch.searchsorted(offsets, slots, right=True),
                          n - 1)
    in_range = slots < num_inst
    local = slots - starts[gid]
    rw = torch.clamp_min(x1 - x0, 1)[gid]
    pixel = torch.where(in_range,
                        (y0[gid] + local // rw) * w + x0[gid] + local % rw,
                        w * h)
    depth_bits = depth.view(torch.int32).long()
    dkey = torch.where(in_range, depth_bits[gid], torch.iinfo(torch.int32).max)
    sorted_key, perm = torch.sort(pixel * (1 << 32) + dkey, stable=True)
    sorted_gid = torch.where(in_range, gid, n)[perm]
    sorted_pixel = sorted_key >> 32

    # the winner of pixel p heads its run
    pixels = torch.arange(w * h, device=dev)
    first = torch.clamp_max(torch.searchsorted(sorted_pixel, pixels),
                            capacity - 1)
    hit = sorted_pixel[first] == pixels
    idx = torch.where(hit, sorted_gid[first], -1).to(torch.int32)
    return idx, depth, num_inst.to(torch.int32)


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` with id N reading a zero row; its backward sums each
    row's cotangents in pixel order (``sum_rows_by_id``), the same bits on
    every run, where ``index_put_(accumulate=True)`` would use atomics on
    CUDA."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n = table.shape[0]
        padded = torch.cat([table, table.new_zeros((1, table.shape[1]))])
        return padded[ids.long()]

    @staticmethod
    def backward(ctx, cot):
        (ids,) = ctx.saved_tensors
        return sum_rows_by_id(cot, ids, ctx.n), None


def render_idxmaps(means3d: torch.Tensor, features: torch.Tensor,
                   cam: CameraParams, capacity: int = 1 << 21,
                   alive: torch.Tensor | None = None,
                   backend: str = "tiled") -> IdxMaps:
    """The z-buffer winner of every pixel and its 64-d feature map.

    ``features`` (N, 64); only dims 25..63 reach the output (0..24 are
    overwritten by depth and the view-direction encoding, as GETMAP does),
    and gradients flow to ``features`` alone. ``backend``: "tiled" (K3;
    ``capacity`` counts tile instances) or "xla" (the per-pixel sort oracle;
    ``capacity`` counts pixel instances, ~25x more).
    """
    w, h = cam.width, cam.height
    if backend == "tiled":
        idx, depth, num_inst = compute_idxmap_tiled(means3d, cam, capacity,
                                                    alive)
    elif backend == "xla":
        idx, depth, num_inst = compute_idxmap(means3d, cam, capacity, alive)
    else:
        raise ValueError(f"backend must be 'tiled' or 'xla', got {backend!r}")
    n = means3d.shape[0]
    hit = (idx >= 0)[:, None]
    ids = torch.where(idx >= 0, idx, n)       # misses read the zero row

    geometry = torch.cat([means3d.detach(), depth.detach()[:, None]], dim=1)
    geometry = torch.cat([geometry, geometry.new_zeros((1, 4))])[ids.long()]
    pos, d = geometry[:, :3], geometry[:, 3:]
    feat_tail = _GatherRows.apply(features[:, PE_DIMS + 1:], ids)  # (P, 39)

    dirs = pos - cam.campos[None, :]
    sq = dirs * dirs          # summed left to right, as the JAX sum runs
    norm2 = torch.clamp_min((sq[:, 0:1] + sq[:, 1:2]) + sq[:, 2:3], 1e-16)
    # the correctly rounded float32 sqrt on every device (PyTorch's
    # vectorised CPU sqrt is off by an ulp on ~0.6 % of inputs, which the
    # 8 pi encoding frequency would lift to ~2e-6)
    dirs = dirs / torch.sqrt(norm2.double()).float()
    fmap = torch.cat([d, positional_encoding_3d(dirs), feat_tail], dim=1)
    return IdxMaps(
        idxmap=idx.reshape(h, w),
        colmap=torch.where(hit, dirs, 0.0).reshape(h, w, 3),
        depthmap=torch.where(hit, d, 0.0).reshape(h, w),
        featuremap=torch.where(hit, fmap, 0.0).reshape(h, w, NUM_FEATURES),
        num_inst=num_inst,
    )
