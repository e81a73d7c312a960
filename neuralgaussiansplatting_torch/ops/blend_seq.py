"""K1 and K2, the blend kernels of 32x32 tiles: the main path's blend.

Port of ``ops/blend_seq.py``. ``blend_seq_fwd`` wraps kernel K1
(``csrc/blend_seq_fwd.cu``, replacing the TPU kernel ``_fwd_kernel``) and
``blend_seq_bwd`` kernel K2 (``csrc/blend_seq_bwd.cu``, replacing
``_bwd_kernel`` and the XLA ``_epilogue``): on a CUDA tensor each launches
its kernel or raises, never falling back; on a CPU tensor each runs its
kernel's plain PyTorch version (``blend_tiles_seq_reference``,
``blend_tiles_seq_bwd_reference``), which repeats the kernel's recurrence in
the same operation order. ``launches`` and ``bwd_launches`` count the K1 and
K2 launches. ``rasterize.blend_tiles`` differentiates through the pair.
"""

from __future__ import annotations

import ctypes

import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops.blend import (
    ALPHA_MAX, ALPHA_MIN, STOP_T, check_blend_inputs, tile_pixel_coords,
)

BX = BY = 32     # tile pitch
PIX = BX * BY

launches = 0      # K1 launches since the caller last set it to 0
bwd_launches = 0  # K2 launches since the caller last set it to 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C signatures of csrc/blend_seq_{fwd,bwd}.cu (the last pointer is the
# stream)
_FWD_ARGS = (_P, _P, _P, _LL, _I, _I, _I, _P, _P)
_BWD_ARGS = (_P, _P, _P, _LL, _P, _P, _I, _I, _I, _P, _P)


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
    check_blend_inputs(packed, tile_start, tile_count, tiles_x, PIX)
    if not _build.on_cuda("blend_seq_fwd", (packed, tile_start, tile_count),
                          "rasterize.blend_tiles"):
        return blend_tiles_seq_reference(packed, tile_start, tile_count,
                                         tiles_x, track_contrib)
    num_tiles = tile_start.shape[0]
    out = torch.empty((num_tiles, 5, PIX), dtype=torch.float32,
                      device=packed.device)
    _build.launch("blend_seq_fwd", _FWD_ARGS, packed.device,
            tile_start.data_ptr(), tile_count.data_ptr(), packed.data_ptr(),
            packed.shape[1], num_tiles, tiles_x, int(track_contrib),
            out.data_ptr())
    launches += 1
    return out


def blend_seq_bwd(packed: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, raw: torch.Tensor,
                  cot: torch.Tensor, tiles_x: int,
                  track_contrib: bool = True) -> torch.Tensor:
    """Backward of ``blend_seq_fwd``: the (9, K) gradient of ``packed``.

    ``raw`` is ``blend_seq_fwd``'s output for the same inputs and ``cot``
    the cotangent of it (row 4, n_contrib, is ignored). Rows of the result:
    d x, d y, d conic A, B, C, d opacity, d r, g, b. Slots past a tile's
    deepest contributor (its largest n_contrib, when ``track_contrib``) and
    past ``tile_count`` are zero.
    """
    global bwd_launches
    check_blend_inputs(packed, tile_start, tile_count, tiles_x, PIX,
                       ("raw", raw), ("cot", cot))
    if not _build.on_cuda("blend_seq_bwd",
                          (packed, tile_start, tile_count, raw, cot),
                          "rasterize.blend_tiles"):
        return blend_tiles_seq_bwd_reference(packed, tile_start, tile_count,
                                             raw, cot, tiles_x, track_contrib)
    grad = torch.zeros_like(packed)
    _build.launch("blend_seq_bwd", _BWD_ARGS, packed.device,
            tile_start.data_ptr(), tile_count.data_ptr(), packed.data_ptr(),
            packed.shape[1], raw.data_ptr(), cot.data_ptr(),
            tile_start.shape[0], tiles_x, int(track_contrib), grad.data_ptr())
    bwd_launches += 1
    return grad


def blend_tiles_seq_reference(packed: torch.Tensor, tile_start: torch.Tensor,
                              tile_count: torch.Tensor, tiles_x: int,
                              track_contrib: bool = True,
                              return_pairs: bool = False):
    """Plain PyTorch version of K1 (``blend_seq_fwd``), on any device.

    A loop over instance index i < max(tile_count), vectorised over
    (tiles x 1024 px), with K1's operation order. With ``return_pairs`` it
    also returns the number of (instance, pixel) pairs visited while the
    pixel was not yet done, and the number of those that blended: the work
    K1 cannot skip.
    """
    check_blend_inputs(packed, tile_start, tile_count, tiles_x, PIX)
    dev = packed.device
    num_tiles = tile_start.shape[0]
    px, py = tile_pixel_coords(tiles_x, num_tiles // tiles_x, BX, BY, dev)
    start = tile_start.long()
    count = tile_count.long()
    t_col = torch.ones((num_tiles, PIX), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=dev)
    cr, cg, cb, last = (torch.zeros_like(t_col) for _ in range(4))
    visited = torch.zeros((), dtype=torch.int64, device=dev)
    blended_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    n_steps = int(count.max()) if num_tiles else 0
    for i in range(n_steps):
        live = i < count                                           # (T,)
        col = torch.clamp(start + i, max=packed.shape[1] - 1)
        attrs = torch.where(live[None, :], packed[:, col], 0.0)    # (9, T)
        mx, my, ca, cbc, cc, op, r, g, b = attrs[:, :, None]        # (T, 1)
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
        if return_pairs:
            visited += (~done & live[:, None]).sum()
            blended_pairs += (alive & (a > 0.0) & live[:, None]).sum()
        t_col = torch.where(alive, t_new, t_col)
        done = done | (t_new < STOP_T)
    raw = torch.stack([cr, cg, cb, t_col, last], dim=1)
    if return_pairs:
        return raw, int(visited), int(blended_pairs)
    return raw


def blend_tiles_seq_bwd_reference(packed: torch.Tensor,
                                  tile_start: torch.Tensor,
                                  tile_count: torch.Tensor, raw: torch.Tensor,
                                  cot: torch.Tensor, tiles_x: int,
                                  track_contrib: bool = True,
                                  return_pairs: bool = False):
    """Plain PyTorch version of K2 (``blend_seq_bwd``), on any device.

    A loop over instance index i < max(stop), where a tile's stop is its
    deepest contributor (or ``tile_count`` without ``track_contrib``),
    vectorised over (tiles x 1024 px) with K2's operation order; the sums
    run over the pixel axis. With ``return_pairs`` it also returns the
    number of (instance, pixel) pairs walked while the pixel was not yet
    done, and the number of those that blended: the work K2 cannot skip.
    """
    check_blend_inputs(packed, tile_start, tile_count, tiles_x, PIX,
                       ("raw", raw), ("cot", cot))
    dev = packed.device
    num_tiles = tile_start.shape[0]
    px, py = tile_pixel_coords(tiles_x, num_tiles // tiles_x, BX, BY, dev)
    start = tile_start.long()
    stop = tile_count.long()
    if track_contrib:
        stop = torch.minimum(stop, raw[:, 4].amax(dim=1).long())
    g_r, g_g, g_b, g_t = cot[:, 0], cot[:, 1], cot[:, 2], cot[:, 3]
    tot = raw[:, 0] * g_r + raw[:, 1] * g_g + raw[:, 2] * g_b + raw[:, 3] * g_t
    t_col = torch.ones((num_tiles, PIX), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=dev)
    prefix = torch.zeros_like(t_col)
    grad = torch.zeros_like(packed)
    walked = torch.zeros((), dtype=torch.int64, device=dev)
    blended_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    n_steps = int(stop.max()) if num_tiles else 0
    for i in range(n_steps):
        live = i < stop                                            # (T,)
        col = torch.clamp(start + i, max=packed.shape[1] - 1)
        attrs = torch.where(live[None, :], packed[:, col], 0.0)    # (9, T)
        mx, my, ca, cbc, cc, op, r, g, b = attrs[:, :, None]        # (T, 1)
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * (dx * dx) + cc * (dy * dy)) - cbc * (dx * dy)
        gexp = torch.exp(power)
        opg = op * gexp
        alpha = torch.clamp_max(opg, ALPHA_MAX)
        a = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, 0.0)
        cdot = r * g_r + g * g_g + b * g_b
        ta = t_col * a
        t_new = t_col - ta
        alive = (t_new >= STOP_T) & ~done
        blended = alive & (a > 0.0)
        w = torch.where(blended, ta, 0.0)
        prefix = prefix + w * cdot
        dalpha = t_col * cdot - (tot - prefix) / (1.0 - a)
        dpow = opg * dalpha
        terms = torch.stack([
            dpow * (-ca * dx - cbc * dy),
            dpow * (-cc * dy - cbc * dx),
            dpow * (-0.5 * dx * dx),
            dpow * (-dx * dy),
            dpow * (-0.5 * dy * dy),
            gexp * dalpha,
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
