"""Sequential-instance blend over 32x32 tiles: the forward render's kernel.

Port of ``ops/blend_seq.py`` (forward only). ``blend_tiles_seq`` is the
public blend; ``blend_seq_fwd`` is the wrapper of kernel K1
(``csrc/blend_seq_fwd.cu``, replacing the TPU kernel ``_fwd_kernel``): on a
CUDA tensor it launches K1 or raises, never falling back; on a CPU tensor
it runs ``blend_tiles_seq_reference``, the plain PyTorch version of the same
recurrence, in the same operation order. ``launches`` counts K1 launches.

The backward (K2) and the per-Gaussian gradient reduction come with the
training slice; until then the seq path refuses tensors that require grad.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops.binning import Instances
from neuralgaussiansplatting_torch.ops.blend import (
    ALPHA_MAX, ALPHA_MIN, STOP_T, BlendResult, tile_pixel_coords,
)
from neuralgaussiansplatting_torch.ops.blend_pallas import (
    PROWS, pack_gather, pack_instance_attrs_t,
)

CHUNK = 128      # binning alignment of each tile's instance segment
BX = BY = 32     # tile pitch
PIX = BX * BY

launches = 0     # K1 launches since the caller last set it to 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("blend_seq_fwd")
    fn = lib.blend_seq_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.blend_seq_fwd_error.argtypes = [ctypes.c_int]
    lib.blend_seq_fwd_error.restype = ctypes.c_char_p
    return lib


def _check_inputs(packed, tile_start, tile_count, tiles_x):
    if packed.dtype != torch.float32 or packed.ndim != 2 \
            or packed.shape[0] != PROWS:
        raise ValueError(f"packed must be ({PROWS}, K) float32, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    for name, a in (("tile_start", tile_start), ("tile_count", tile_count)):
        if a.dtype != torch.int32 or a.ndim != 1:
            raise ValueError(f"{name} must be (T,) int32, got "
                             f"{tuple(a.shape)} {a.dtype}")
        if a.device != packed.device:
            raise ValueError(f"{name} is on {a.device}, packed on "
                             f"{packed.device}")
    num_tiles = tile_start.shape[0]
    if tile_count.shape[0] != num_tiles or num_tiles % tiles_x:
        raise ValueError(f"{num_tiles} tile starts, {tile_count.shape[0]} "
                         f"counts, {tiles_x} tiles per row")


def blend_seq_fwd(packed: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, tiles_x: int,
                  track_contrib: bool = True) -> torch.Tensor:
    """Blend every 32x32 tile: (9, K) packed instances -> (T, 5, 1024).

    Output rows per tile: r, g, b, final T, n_contrib (1-based, as float;
    zeros when ``track_contrib`` is False). Pixel p of a tile is at
    (p % 32, p // 32). Tile t's instances are columns
    [tile_start[t], tile_start[t] + tile_count[t]) of ``packed``.
    """
    global launches
    _check_inputs(packed, tile_start, tile_count, tiles_x)
    if packed.device.type == "cpu":
        return blend_tiles_seq_reference(packed, tile_start, tile_count,
                                         tiles_x, track_contrib)
    if packed.device.type != "cuda":
        raise ValueError(f"no K1 for device {packed.device}")
    if not all(a.is_contiguous() for a in (packed, tile_start, tile_count)):
        raise ValueError("K1 takes contiguous packed, tile_start and "
                         "tile_count")
    num_tiles = tile_start.shape[0]
    out = torch.empty((num_tiles, 5, PIX), dtype=torch.float32,
                      device=packed.device)
    lib = _lib()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = lib.blend_seq_fwd(
            tile_start.data_ptr(), tile_count.data_ptr(), packed.data_ptr(),
            packed.shape[1], num_tiles, tiles_x, int(track_contrib),
            out.data_ptr(), stream)
    if err:
        raise RuntimeError("blend_seq_fwd launch failed: "
                           + lib.blend_seq_fwd_error(err).decode())
    launches += 1
    return out


def blend_tiles_seq_reference(packed: torch.Tensor, tile_start: torch.Tensor,
                              tile_count: torch.Tensor, tiles_x: int,
                              track_contrib: bool = True,
                              return_visited: bool = False):
    """Plain PyTorch version of K1 (``blend_seq_fwd``), on any device.

    A loop over instance index i < max(tile_count), vectorised over
    (tiles x 1024 px), with K1's operation order. With ``return_visited``
    it also returns the (T, 1024) count of instances each pixel visited
    while it was not yet done: the pairs the blend cannot skip.
    """
    _check_inputs(packed, tile_start, tile_count, tiles_x)
    dev = packed.device
    num_tiles = tile_start.shape[0]
    px, py = tile_pixel_coords(tiles_x, num_tiles // tiles_x, BX, BY, dev)
    start = tile_start.long()
    count = tile_count.long()
    t_col = torch.ones((num_tiles, PIX), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=dev)
    cr, cg, cb, last = (torch.zeros_like(t_col) for _ in range(4))
    visited = torch.zeros((num_tiles, PIX), dtype=torch.int64, device=dev)
    n_steps = int(count.max()) if num_tiles else 0
    for i in range(n_steps):
        live = i < count                                           # (T,)
        col = torch.clamp(start + i, max=packed.shape[1] - 1)
        attrs = torch.where(live[None, :], packed[:, col], 0.0)    # (9, T)
        mx, my, ca, cbc, cc, op, r, g, b = attrs[:, :, None]        # (T, 1)
        if return_visited:
            visited += (~done & live[:, None]).long()
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * (dx * dx) + cc * (dy * dy)) - cbc * (dx * dy)
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        a = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, 0.0)
        ta = t_col * a
        t_new = t_col - ta
        alive = (t_new >= STOP_T) & ~done
        w = torch.where(alive, ta, 0.0)
        cr = cr + w * r
        cg = cg + w * g
        cb = cb + w * b
        if track_contrib:
            last = torch.where(alive & (a > 0.0), float(i + 1), last)
        t_col = torch.where(alive, t_new, t_col)
        done = done | (t_new < STOP_T)
    raw = torch.stack([cr, cg, cb, t_col, last], dim=1)
    return (raw, visited) if return_visited else raw


def blend_tiles_seq(inst: Instances, means2d: torch.Tensor,
                    conic: torch.Tensor, opacity: torch.Tensor,
                    rgb: torch.Tensor, tiles_x: int, tiles_y: int,
                    block_x: int, block_y: int, max_per_tile: int,
                    chunk: int = CHUNK,
                    track_contrib: bool = True) -> BlendResult:
    """Same contract as ``blend.blend_tiles``, through K1 on a CUDA device.

    Takes 32x32 tiles and chunk 128 only (ValueError otherwise);
    ``max_per_tile`` is already applied by binning.
    """
    del max_per_tile
    if (block_x, block_y) != (BX, BY) or chunk != CHUNK:
        raise ValueError(
            f"the seq blend takes {BX}x{BY} tiles and {CHUNK}-wide chunks, "
            f"got {block_x}x{block_y} tiles, chunk {chunk}")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (means2d, conic, opacity, rgb)):
        raise NotImplementedError(
            "the seq blend is forward-only until its backward (K2) is "
            "ported; render under torch.no_grad() or use backend='xla'")
    if inst.tile_start.shape[0] != tiles_x * tiles_y:
        raise ValueError(f"{inst.tile_start.shape[0]} tiles binned, "
                         f"{tiles_x * tiles_y} expected")
    packed = pack_gather(pack_instance_attrs_t(means2d, conic, opacity, rgb),
                         inst.gid)
    raw = blend_seq_fwd(packed, inst.tile_start, inst.tile_count, tiles_x,
                        track_contrib)
    return BlendResult(color=raw[:, 0:3].transpose(1, 2),
                       final_t=raw[:, 3],
                       n_contrib=raw[:, 4].to(torch.int32))
