"""Tiled z-buffer for the neural pipeline's idxmap pass: kernel K3.

Port of ``ops/zbuffer_pallas.py``. Each Gaussian is a point whose pixel
footprint is a square of radius 3 / depth; the footprints are binned into
32x32 tiles by the classic rasterizer's ``binning.bin_gaussians`` (one
instance per covered tile), and K3 (``csrc/zbuffer_fwd.cu``, replacing the
TPU kernel ``_zbuf_kernel``) takes, for every pixel, the nearest instance of
its tile whose rect covers it; equal depths go to the lower Gaussian id.
The kernel takes that minimum over 64-bit keys, the depth's bits mapped to
an order-preserving uint32 (``depth_key``) above the id, so that the order
of a tile's instances changes no bit; ``depth_key`` and ``key_depth`` are
the PyTorch versions of its encoding.

``zbuf_tiles`` is K3's wrapper: on a CUDA tensor it launches the kernel or
raises, never falling back; on a CPU tensor it runs the plain PyTorch
version ``zbuf_tiles_reference``. ``launches`` counts the K3 launches.

Ids are int32 throughout, so the JAX kernel's limit of 2^24 Gaussians (ids
ride a float32 lane there) does not apply. Geometry gets no gradient, by
reference semantics: the outputs are integer ids and detached depths.
"""

from __future__ import annotations

import ctypes

import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.ops.blend import assemble_image
from neuralgaussiansplatting_torch.ops.preprocess import (
    CameraParams, Preprocessed,
)

CHUNK = 128       # binning alignment of each tile's instance segment
BX = BY = 32      # tile pitch
PIX = BX * BY
RECT_ROWS = 5     # rect table rows: x0, y0, x1, y1, gid
BIG = 3.0e38      # the JAX kernel's initial depth: no hit at or above it
POINT_SIZE = 3.0  # footprint radius S / depth (rasterizer2 raster.cu:82)

launches = 0      # K3 launches since the caller last set it to 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C signature of csrc/zbuffer_fwd.cu (the last pointer is the stream)
_ARGS = (_P, _P, _P, _P, _LL, _I, _I, _P, _P, _P)


def _check_inputs(rects, depth, tile_start, tile_count, tiles_x):
    if rects.dtype != torch.int32 or rects.ndim != 2 \
            or rects.shape[0] != RECT_ROWS:
        raise ValueError(f"rects must be ({RECT_ROWS}, K) int32, got "
                         f"{tuple(rects.shape)} {rects.dtype}")
    if depth.dtype != torch.float32 or tuple(depth.shape) != (rects.shape[1],):
        raise ValueError(f"depth must be ({rects.shape[1]},) float32, got "
                         f"{tuple(depth.shape)} {depth.dtype}")
    for name, a in (("tile_start", tile_start), ("tile_count", tile_count)):
        if a.dtype != torch.int32 or a.ndim != 1:
            raise ValueError(f"{name} must be (T,) int32, got "
                             f"{tuple(a.shape)} {a.dtype}")
    for name, a in (("depth", depth), ("tile_start", tile_start),
                    ("tile_count", tile_count)):
        if a.device != rects.device:
            raise ValueError(f"{name} is on {a.device}, rects on "
                             f"{rects.device}")
    num_tiles = tile_start.shape[0]
    if tile_count.shape[0] != num_tiles or num_tiles % tiles_x:
        raise ValueError(f"{num_tiles} tile starts, {tile_count.shape[0]} "
                         f"counts, {tiles_x} tiles per row")


def zbuf_tiles(rects: torch.Tensor, depth: torch.Tensor,
               tile_start: torch.Tensor, tile_count: torch.Tensor,
               tiles_x: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel nearest covering instance of every 32x32 tile.

    ``rects`` (5, K) int32 holds each instance's pixel rect x0, y0, x1, y1
    (x1, y1 exclusive) and Gaussian id; ``depth`` (K,) float32 its view
    depth. Tile t's instances are columns [tile_start[t], tile_start[t] +
    tile_count[t]). Returns (gid, depth), each (T, 1024): the winner's id
    (-1 on a miss) and depth (0 on a miss) at pixel p = (p % 32, p // 32)
    of the tile.
    """
    global launches
    _check_inputs(rects, depth, tile_start, tile_count, tiles_x)
    if not _build.on_cuda("zbuffer_fwd",
                          (rects, depth, tile_start, tile_count)):
        return zbuf_tiles_reference(rects, depth, tile_start, tile_count,
                                    tiles_x)
    num_tiles = tile_start.shape[0]
    out_gid = torch.empty((num_tiles, PIX), dtype=torch.int32,
                          device=rects.device)
    out_depth = torch.empty((num_tiles, PIX), dtype=torch.float32,
                            device=rects.device)
    _build.launch("zbuffer_fwd", _ARGS, rects.device,
                  tile_start.data_ptr(), tile_count.data_ptr(),
                  rects.data_ptr(), depth.data_ptr(), rects.shape[1],
                  num_tiles, tiles_x, out_gid.data_ptr(), out_depth.data_ptr())
    launches += 1
    return out_gid, out_depth


def zbuf_tiles_reference(rects: torch.Tensor, depth: torch.Tensor,
                         tile_start: torch.Tensor, tile_count: torch.Tensor,
                         tiles_x: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 (``zbuf_tiles``), on any device.

    A loop over instance index i < max(tile_count), vectorised over
    (tiles x 1024 px), with K3's test: a hit replaces the pixel's winner
    when its depth is smaller, or equal with a smaller id.
    """
    _check_inputs(rects, depth, tile_start, tile_count, tiles_x)
    dev = rects.device
    num_tiles = tile_start.shape[0]
    t = torch.arange(num_tiles, dtype=torch.int32, device=dev)[:, None]
    j = torch.arange(PIX, dtype=torch.int32, device=dev)[None, :]
    px = (t % tiles_x) * BX + j % BX                                # (T, P)
    py = (t // tiles_x) * BY + j // BX
    start = tile_start.long()
    count = tile_count.long()
    dmin = torch.full((num_tiles, PIX), BIG, dtype=torch.float32, device=dev)
    gwin = torch.full((num_tiles, PIX), torch.iinfo(torch.int32).max,
                      dtype=torch.int32, device=dev)
    n_steps = int(count.max()) if num_tiles else 0
    for i in range(n_steps):
        live = i < count                                            # (T,)
        col = torch.clamp(start + i, max=rects.shape[1] - 1)
        x0, y0, x1, y1, g = torch.where(live[None, :], rects[:, col],
                                        0)[:, :, None]              # (T, 1)
        d = torch.where(live, depth[col], 0.0)[:, None]
        hit = (px >= x0) & (px < x1) & (py >= y0) & (py < y1)
        better = hit & ((d < dmin) | ((d == dmin) & (g < gwin)))
        dmin = torch.where(better, d, dmin)
        gwin = torch.where(better, g, gwin)
    miss = dmin >= BIG
    return (torch.where(miss, -1, gwin),
            torch.where(miss, 0.0, dmin))


def depth_key(depth: torch.Tensor) -> torch.Tensor:
    """K3's order-preserving key of float32 depths (``depth_key`` in
    ``csrc/zbuffer_fwd.cu``), as int64 in [0, 2^32): for depths that are not
    NaN, a < b iff key(a) < key(b) and a == b iff key(a) == key(b), so -0.0
    and +0.0 share the key 0x7fffffff. Non-negative floats map to bits +
    0x7fffffff, negative ones to the bits' complement."""
    u = depth.to(torch.float32).contiguous().view(torch.int32).long() \
        & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u + 0x7FFFFFFF)


def key_depth(key: torch.Tensor) -> torch.Tensor:
    """The float32 depths of ``depth_key``'s keys (+0.0 for the zero key),
    as ``key_depth`` in ``csrc/zbuffer_fwd.cu``."""
    u = torch.where(key >= 0x7FFFFFFF, key - 0x7FFFFFFF, 0xFFFFFFFF - key)
    return (((u + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(
        torch.int32).view(torch.float32)


def point_footprints(means3d: torch.Tensor, cam: CameraParams,
                     point_size: float = POINT_SIZE):
    """(depth, x0, y0, x1, y1, valid) of every point: its view depth, its
    pixel rect [x0, x1) x [y0, y1) (int32, float bounds truncated as the
    reference does, raster.cu:51-52), and whether it is in front of the
    camera (z > 0.2) with its centre pixel on screen."""
    w, h = cam.width, cam.height
    depth = proj.transform_points_4x3(means3d, cam.view)[:, 2]
    ndc = proj.project_points(means3d, cam.full_proj)
    fx = proj.ndc2pix(ndc[:, 0], w)
    fy = proj.ndc2pix(ndc[:, 1], h)
    # .to(int32) truncates toward zero, as the JAX astype and the reference's
    # int cast do: a centre in (-1, 0) counts as column or row 0
    cx = fx.to(torch.int32)
    cy = fy.to(torch.int32)
    radius = point_size / depth
    x0 = torch.clamp_min(fx - radius, 0.0).to(torch.int32)
    y0 = torch.clamp_min(fy - radius, 0.0).to(torch.int32)
    x1 = torch.clamp_max(fx + radius + 1.0, float(w)).to(torch.int32)
    y1 = torch.clamp_max(fy + radius + 1.0, float(h)).to(torch.int32)
    valid = (depth > 0.2) & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    return depth, x0, y0, x1, y1, valid


def binning_call(means3d: torch.Tensor, cam: CameraParams, capacity: int,
                 alive: torch.Tensor | None = None,
                 point_size: float = POINT_SIZE):
    """The points' footprints as ``binning.bin_gaussians`` takes them for
    K3, and the rest of that call: (pre, args, kw, footprints), where
    ``bin_gaussians(pre, *args, **kw)`` bins them into 32x32 tiles and
    ``footprints`` = (depth, x0, y0, x1, y1) are the points' view-space z
    and pixel rects as ``point_footprints`` gives them."""
    means3d = means3d.detach()
    n = means3d.shape[0]
    w, h = cam.width, cam.height
    tiles_x = (w + BX - 1) // BX
    tiles_y = (h + BY - 1) // BY

    depth, x0, y0, x1, y1, valid = point_footprints(means3d, cam, point_size)
    if alive is not None:
        valid = valid & alive
    valid = valid & (x1 > x0) & (y1 > y0)

    # tile rect of the pixel rect (x1/y1 exclusive in pixels -> exclusive
    # tile index from the last covered pixel)
    zero = torch.zeros_like(x0)
    tx0 = torch.where(valid, x0 // BX, zero)
    ty0 = torch.where(valid, y0 // BY, zero)
    tx1 = torch.where(valid, (x1 - 1) // BX + 1, zero)
    ty1 = torch.where(valid, (y1 - 1) // BY + 1, zero)
    pre = Preprocessed(
        means2d=means3d.new_zeros((n, 2)),
        depths=depth,
        radii=valid.to(torch.int32),
        conic=means3d.new_zeros((n, 3)),
        opacity=valid.to(depth.dtype),
        rgb=means3d.new_zeros((n, 3)),
        rect_min=torch.stack([tx0, ty0], -1),
        rect_max=torch.stack([tx1, ty1], -1),
        tiles_touched=torch.where(valid, (tx1 - tx0) * (ty1 - ty0), zero),
    )
    kw = dict(max_per_tile=1 << 30, align=CHUNK, pack_keys=True,
              precise_cull=False, block_x=BX, block_y=BY, width=w, height=h)
    return pre, (tiles_x, tiles_y, capacity), kw, (depth, x0, y0, x1, y1)


def zbuf_inputs(means3d: torch.Tensor, cam: CameraParams, capacity: int,
                alive: torch.Tensor | None = None,
                point_size: float = POINT_SIZE):
    """K3's arguments for one view: the points' footprints binned into
    32x32 tiles and gathered into the rect table.

    Returns (args, depth, demand): ``args`` = (rects, instance depths,
    tile_start, tile_count, tiles_x) as ``zbuf_tiles`` takes them, ``depth``
    (N,) the points' view-space z and ``demand`` as ``compute_idxmap_tiled``
    returns it.
    """
    pre, args, kw, (depth, x0, y0, x1, y1) = binning_call(
        means3d, cam, capacity, alive, point_size)
    inst = binning.bin_gaussians(pre, *args, **kw)
    tiles_x = args[0]

    # per-instance rect and depth by inst.gid; padding slots (gid == N)
    # read the zero column, a rect that covers no pixel
    table = torch.stack([x0, y0, x1, y1])                           # (4, N)
    table = torch.cat([table, table.new_zeros((4, 1))], dim=1)
    gid = inst.gid.long()
    rects = torch.cat([table[:, gid], inst.gid[None]]).contiguous()
    inst_depth = torch.cat([depth, depth.new_zeros(1)])[gid].contiguous()
    # binning drops whole tiles when the 128-aligned segment demand exceeds
    # capacity, which on sparse scenes can far exceed the raw instance
    # count: the monitor covers both
    demand = torch.maximum(inst.num_rendered, inst.aligned_demand)
    return ((rects, inst_depth, inst.tile_start, inst.tile_count, tiles_x),
            depth, demand)


def compute_idxmap_tiled(means3d: torch.Tensor, cam: CameraParams,
                         capacity: int, alive: torch.Tensor | None = None,
                         point_size: float = POINT_SIZE):
    """The closest Gaussian of every pixel, through 32x32 tiles and K3.

    Returns (idx (H*W,) int32 with -1 on a miss, depth (N,) view-space z,
    demand () int32). ``capacity`` counts tile instances (one per covered
    tile). ``demand`` is max(num_rendered, aligned_demand): when it exceeds
    ``capacity`` binning truncated instances or dropped whole tiles, and the
    caller should grow ``capacity``. ``alive`` masks out capacity-padding
    slots (they sit at the origin and would win pixels).
    """
    args, depth, demand = zbuf_inputs(means3d, cam, capacity, alive,
                                      point_size)
    win, _ = zbuf_tiles(*args)
    w, h = cam.width, cam.height
    tiles_x = args[-1]
    idx = assemble_image(win, tiles_x, win.shape[0] // tiles_x, BX, BY, w,
                         h).reshape(w * h)
    return idx, depth, demand
