"""K4 and K5, the blend kernels of any tile shape: the 16x16 lane-layout
blend.

Port of ``ops/blend_pallas.py``. ``blend_pallas_fwd`` wraps kernel K4
(``csrc/blend_pallas_fwd.cu``, replacing the TPU kernel ``_fwd_kernel``) and
``blend_pallas_bwd`` kernel K5 (``csrc/blend_pallas_bwd.cu``, replacing
``_bwd_kernel``): on a CUDA tensor each launches its kernel or raises, never
falling back; on a CPU tensor each runs its kernel's plain PyTorch version
(``blend_tiles_pallas_reference``, ``blend_tiles_pallas_bwd_reference``),
which repeats the kernel's recurrence in the same operation order. Both
take any tile shape up to ``MAX_PIX`` pixels; the binning chunk is only the
alignment of each tile's segment and changes nothing in them. ``launches``
and ``bwd_launches`` count the K4 and K5 launches, and ``kernel_layout``
reports their launch and residency on the card. ``rasterize.blend_tiles``
differentiates through the pair.
"""

from __future__ import annotations

import ctypes

import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops.blend import (
    ALPHA_MAX, ALPHA_MIN, STOP_T, check_blend_inputs, tile_pixel_coords,
)

MAX_PIX = 2048   # most pixels in a tile K4/K5 take (K4: 8 blocks of 256
                 # threads; K5: 256 threads x 8 pixels)

launches = 0      # K4 launches since the caller last set it to 0
bwd_launches = 0  # K5 launches since the caller last set it to 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C signatures of csrc/blend_pallas_{fwd,bwd}.cu (the last pointer is
# the stream)
_FWD_ARGS = (_P, _P, _P, _LL, _I, _I, _I, _I, _I, _P, _P)
_BWD_ARGS = (_P, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _P, _P)


def _tile_pix(block_x: int, block_y: int) -> int:
    if block_x < 1 or block_y < 1 or block_x * block_y > MAX_PIX:
        raise ValueError(f"K4/K5 take tiles of 1 to {MAX_PIX} pixels, got "
                         f"{block_x}x{block_y}")
    return block_x * block_y


def blend_pallas_fwd(packed: torch.Tensor, tile_start: torch.Tensor,
                     tile_count: torch.Tensor, tiles_x: int, block_x: int,
                     block_y: int, track_contrib: bool = True) -> torch.Tensor:
    """Blend every block_x x block_y tile: (9, K) packed instances ->
    (T, 5, block_x * block_y).

    Output rows per tile: r, g, b, final T, n_contrib (1-based, as float;
    zeros when ``track_contrib`` is False). Pixel p of tile t is at
    (tx * block_x + p % block_x, ty * block_y + p // block_x). Tile t's
    instances are columns [tile_start[t], tile_start[t] + tile_count[t]) of
    ``packed``.
    """
    global launches
    pix = _tile_pix(block_x, block_y)
    check_blend_inputs(packed, tile_start, tile_count, tiles_x, pix)
    if not _build.on_cuda("blend_pallas_fwd",
                          (packed, tile_start, tile_count),
                          "rasterize.blend_tiles"):
        return blend_tiles_pallas_reference(packed, tile_start, tile_count,
                                            tiles_x, block_x, block_y,
                                            track_contrib)
    num_tiles = tile_start.shape[0]
    out = torch.empty((num_tiles, 5, pix), dtype=torch.float32,
                      device=packed.device)
    _build.launch("blend_pallas_fwd", _FWD_ARGS, packed.device,
                  tile_start.data_ptr(), tile_count.data_ptr(),
                  packed.data_ptr(), packed.shape[1], num_tiles, tiles_x,
                  block_x, block_y, int(track_contrib), out.data_ptr())
    launches += 1
    return out


def blend_pallas_bwd(packed: torch.Tensor, tile_start: torch.Tensor,
                     tile_count: torch.Tensor, raw: torch.Tensor,
                     cot: torch.Tensor, tiles_x: int, block_x: int,
                     block_y: int, track_contrib: bool = True) -> torch.Tensor:
    """Backward of ``blend_pallas_fwd``: the (9, K) gradient of ``packed``.

    ``raw`` is ``blend_pallas_fwd``'s output for the same inputs and ``cot``
    the cotangent of it (row 4, n_contrib, is ignored). Rows of the result:
    d x, d y, d conic A, B, C, d opacity, d r, g, b. Slots past a tile's
    deepest contributor (its largest n_contrib, when ``track_contrib``) and
    past ``tile_count`` are zero.
    """
    global bwd_launches
    pix = _tile_pix(block_x, block_y)
    check_blend_inputs(packed, tile_start, tile_count, tiles_x, pix,
                       ("raw", raw), ("cot", cot))
    if not _build.on_cuda("blend_pallas_bwd",
                          (packed, tile_start, tile_count, raw, cot),
                          "rasterize.blend_tiles"):
        return blend_tiles_pallas_bwd_reference(
            packed, tile_start, tile_count, raw, cot, tiles_x, block_x,
            block_y, track_contrib)
    grad = torch.zeros_like(packed)
    _build.launch("blend_pallas_bwd", _BWD_ARGS, packed.device,
                  tile_start.data_ptr(), tile_count.data_ptr(),
                  packed.data_ptr(), packed.shape[1], raw.data_ptr(),
                  cot.data_ptr(), tile_start.shape[0], tiles_x, block_x,
                  block_y, int(track_contrib), grad.data_ptr())
    bwd_launches += 1
    return grad


def kernel_layout(name: str, block_x: int, block_y: int) -> dict:
    """The launch that kernel ``name`` ("blend_pallas_fwd" or
    "blend_pallas_bwd") takes for a block_x x block_y tile, and its
    residency on the current card, as the CUDA runtime reports them:
    threads and CTAs per tile, registers per thread, static and dynamic
    shared memory bytes per CTA, resident CTAs per SM. Needs the card."""
    _tile_pix(block_x, block_y)
    fn = getattr(_build.load(name), name + "_layout")
    fn.argtypes = [_I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    info = (_I * 6)()
    code = fn(block_x, block_y, info)
    if code:
        raise RuntimeError(f"{name}_layout failed with CUDA error {code}")
    keys = ("threads", "ctas_per_tile", "registers", "static_smem",
            "dynamic_smem", "ctas_per_sm")
    return dict(zip(keys, info))


def _instance_step(packed, start, i, live, px, py):
    """Instance ``i`` of every tile against the tile's pixels, in K4/K5's
    operation order: (col, attrs, dx, dy, g_exp, a), where ``a`` is the
    masked alpha."""
    col = torch.clamp(start + i, max=packed.shape[1] - 1)
    attrs = torch.where(live[None, :], packed[:, col], 0.0)        # (9, T)
    mx, my, ca, cbc, cc, op = attrs[:6, :, None]                    # (T, 1)
    dx = mx - px
    dy = my - py
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cbc * dx * dy
    g_exp = torch.exp(power)
    alpha = torch.clamp_max(op * g_exp, ALPHA_MAX)
    a = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, 0.0)
    return col, attrs[:, :, None], dx, dy, g_exp, a


def blend_tiles_pallas_reference(packed: torch.Tensor,
                                 tile_start: torch.Tensor,
                                 tile_count: torch.Tensor, tiles_x: int,
                                 block_x: int, block_y: int,
                                 track_contrib: bool = True,
                                 return_pairs: bool = False):
    """Plain PyTorch version of K4 (``blend_pallas_fwd``), on any device.

    A loop over instance index i < max(tile_count), vectorised over
    (tiles x pixels), with K4's operation order. With ``return_pairs`` it
    also returns the number of (instance, pixel) pairs visited while the
    pixel was not yet done, and the number of those that blended: the work
    K4 cannot skip.
    """
    pix = _tile_pix(block_x, block_y)
    check_blend_inputs(packed, tile_start, tile_count, tiles_x, pix)
    dev = packed.device
    num_tiles = tile_start.shape[0]
    px, py = tile_pixel_coords(tiles_x, num_tiles // tiles_x, block_x,
                               block_y, dev)
    start = tile_start.long()
    count = tile_count.long()
    t_col = torch.ones((num_tiles, pix), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, pix), dtype=torch.bool, device=dev)
    cr, cg, cb, last = (torch.zeros_like(t_col) for _ in range(4))
    visited = torch.zeros((), dtype=torch.int64, device=dev)
    blended_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    n_steps = int(count.max()) if num_tiles else 0
    for i in range(n_steps):
        live = i < count                                           # (T,)
        _, attrs, _, _, _, a = _instance_step(packed, start, i, live, px, py)
        r, g, b = attrs[6:9]
        t_new = t_col * (1.0 - a)
        alive = (t_new >= STOP_T) & ~done
        w = torch.where(alive, a * t_col, 0.0)
        cr = cr + w * r
        cg = cg + w * g
        cb = cb + w * b
        if track_contrib:
            last = torch.where(alive & (a > 0.0), float(i + 1), last)
        if return_pairs:
            visited += (~done & live[:, None]).sum()
            blended_pairs += (alive & (a > 0.0) & live[:, None]).sum()
        t_col = torch.where(alive, t_new, t_col)
        done = done | (t_new < STOP_T)
    raw = torch.stack([cr, cg, cb, t_col, last], dim=1)
    if return_pairs:
        return raw, int(visited), int(blended_pairs)
    return raw


def blend_tiles_pallas_bwd_reference(packed: torch.Tensor,
                                     tile_start: torch.Tensor,
                                     tile_count: torch.Tensor,
                                     raw: torch.Tensor, cot: torch.Tensor,
                                     tiles_x: int, block_x: int, block_y: int,
                                     track_contrib: bool = True,
                                     return_pairs: bool = False):
    """Plain PyTorch version of K5 (``blend_pallas_bwd``), on any device.

    A loop over instance index i < max(stop), where a tile's stop is its
    deepest contributor (or ``tile_count`` without ``track_contrib``),
    vectorised over (tiles x pixels) with K5's operation order; the sums run
    over the pixel axis. With ``return_pairs`` it also returns the number of
    (instance, pixel) pairs walked while the pixel was not yet done, and the
    number of those that blended: the work K5 cannot skip.
    """
    pix = _tile_pix(block_x, block_y)
    check_blend_inputs(packed, tile_start, tile_count, tiles_x, pix,
                       ("raw", raw), ("cot", cot))
    dev = packed.device
    num_tiles = tile_start.shape[0]
    px, py = tile_pixel_coords(tiles_x, num_tiles // tiles_x, block_x,
                               block_y, dev)
    start = tile_start.long()
    stop = tile_count.long()
    if track_contrib:
        stop = torch.minimum(stop, raw[:, 4].amax(dim=1).long())
    g_r, g_g, g_b, g_t = cot[:, 0], cot[:, 1], cot[:, 2], cot[:, 3]
    total_dot = raw[:, 0] * g_r + raw[:, 1] * g_g + raw[:, 2] * g_b
    tfin_gt = raw[:, 3] * g_t
    t_col = torch.ones((num_tiles, pix), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, pix), dtype=torch.bool, device=dev)
    prefix = torch.zeros_like(t_col)
    grad = torch.zeros_like(packed)
    walked = torch.zeros((), dtype=torch.int64, device=dev)
    blended_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    n_steps = int(stop.max()) if num_tiles else 0
    for i in range(n_steps):
        live = i < stop                                            # (T,)
        col, attrs, dx, dy, g_exp, a = _instance_step(packed, start, i, live,
                                                      px, py)
        _, _, ca, cbc, cc, op, r, g, b = attrs
        one_minus = 1.0 - a
        t_new = t_col * one_minus
        alive = (t_new >= STOP_T) & ~done
        blended = alive & (a > 0.0)
        w = torch.where(blended, a * t_col, 0.0)
        cdot = r * g_r + g * g_g + b * g_b
        prefix = prefix + w * cdot
        suffix = total_dot - prefix
        dalpha = torch.where(
            blended, t_col * cdot - (suffix + tfin_gt) / one_minus, 0.0)
        dpow = g_exp * (op * dalpha)
        terms = torch.stack([
            dpow * (-ca * dx - cbc * dy),
            dpow * (-cc * dy - cbc * dx),
            dpow * (-0.5 * dx * dx),
            dpow * (-dx * dy),
            dpow * (-0.5 * dy * dy),
            g_exp * dalpha,
            w * g_r,
            w * g_g,
            w * g_b,
        ])                                                         # (9, T, P)
        sums = torch.where(blended, terms, 0.0).sum(dim=2)         # (9, T)
        grad[:, col[live]] = sums[:, live]
        if return_pairs:
            walked += (~done & live[:, None]).sum()
            blended_pairs += (blended & live[:, None]).sum()
        t_col = torch.where(alive, t_new, t_col)
        done = done | (t_new < STOP_T)
    if return_pairs:
        return grad, int(walked), int(blended_pairs)
    return grad
