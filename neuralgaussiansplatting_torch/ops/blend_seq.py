"""Sequential-instance blend over 32x32 tiles: the render's kernels.

Port of ``ops/blend_seq.py``. ``blend_tiles_seq`` is the public blend,
differentiable through ``torch.autograd``: its forward is kernel K1
(``csrc/blend_seq_fwd.cu``, replacing the TPU kernel ``_fwd_kernel``) and its
backward kernel K2 (``csrc/blend_seq_bwd.cu``, replacing ``_bwd_kernel`` and
the XLA ``_epilogue``), with the JAX ``custom_vjp``'s contract.

``blend_seq_fwd`` and ``blend_seq_bwd`` are the kernels' wrappers: on a CUDA
tensor each launches its kernel or raises, never falling back; on a CPU
tensor each runs its kernel's plain PyTorch version
(``blend_tiles_seq_reference``, ``blend_tiles_seq_bwd_reference``), which
repeats the kernel's recurrence in the same operation order. ``launches``
and ``bwd_launches`` count the K1 and K2 launches. ``alpha_floor_cutoff``
is the power cutoff below which both kernels skip a pair's ``expf``, and
``instance_box`` the box outside which a warp skips an instance;
``stage_cutoff_box`` gives both per instance, on a CUDA tensor as the
kernels' own device code computes them (``csrc/blend_seq_stage.cu``). K4 and
K5 (``ops/blend_pallas.py``) skip by the same cutoff and box, with the power
in their own association (``blend_power``). ``blend_pair_counts`` counts the
pairs each of the four kernels needs, for their bounds.
"""

from __future__ import annotations

import ctypes
import math

import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops.binning import Instances
from neuralgaussiansplatting_torch.ops.blend import (
    ALPHA_MAX, ALPHA_MIN, STOP_T, BlendResult, tile_pixel_coords,
)
from neuralgaussiansplatting_torch.ops.blend_pallas import (
    check_blend_inputs, pack_gather, pack_instance_attrs_t,
)

CHUNK = 128      # binning alignment of each tile's instance segment
BX = BY = 32     # tile pitch
PIX = BX * BY

launches = 0      # K1 launches since the caller last set it to 0
bwd_launches = 0  # K2 launches since the caller last set it to 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C signatures of csrc/blend_seq_{fwd,bwd}.cu (the last pointer is the
# stream)
_FWD_ARGS = (_P, _P, _P, _LL, _I, _I, _I, _P, _P)
_BWD_ARGS = (_P, _P, _P, _LL, _P, _P, _I, _I, _I, _P, _P)
_STAGE_ARGS = (_P, _LL, _P, _P)
# the two float32 associations of the power: K1 and K2's ("seq") and K4 and
# K5's, the JAX pallas kernel's ("pallas")
ASSOCIATIONS = ("seq", "pallas")


def blend_power(dx, dy, ca, cbc, cc, association: str = "seq"):
    """The power -q/2 of pixel offsets (dx, dy) under conic (A, B, C), as the
    blend kernels round it in float32: ``"seq"`` (K1, K2)
    -0.5 * (A*(dx*dx) + C*(dy*dy)) - B*(dx*dy); ``"pallas"`` (K4, K5)
    -0.5 * ((A*dx)*dx + (C*dy)*dy) - (B*dx)*dy."""
    if association == "seq":
        return -0.5 * (ca * (dx * dx) + cc * (dy * dy)) - cbc * (dx * dy)
    if association == "pallas":
        return -0.5 * (ca * dx * dx + cc * dy * dy) - cbc * dx * dy
    raise ValueError(f"association must be one of {ASSOCIATIONS}, got "
                     f"{association!r}")


def alpha_floor_cutoff(op: torch.Tensor) -> torch.Tensor:
    """Per-instance power cutoff of the kernels' alpha-floor skip (float32).

    For power < alpha_floor_cutoff(op), min(0.99, op * exp(power)) lies
    below ALPHA_MIN in float32, so the pair's alpha is 0 and K1 and K2 skip
    its ``expf``. ``seq_cutoff`` in ``csrc/blend_seq_common.cuh`` computes
    the same: ln(ALPHA_MIN / op) less a margin of 2^-13 (1 + |ln|), which
    covers the rounding of the division, the log, the exp and the product
    (a few ulps, ~1e-6 (1 + |ln|) of power). op <= 0 gives NaN or -inf: no
    pair is skipped.
    """
    ln = torch.log(ALPHA_MIN / op)
    return ln - (1.0 + ln.abs()) * 2.0 ** -13


def instance_box(mx, my, ca, cbc, cc, op) -> torch.Tensor:
    """Per-instance box (x_lo, x_hi, y_lo, y_hi) of the kernels' warp test
    (float32, (4, N)): at a pixel outside it the power that K1, K2, K4 and
    K5 compute (in either association of ``blend_power``) lies below
    ``alpha_floor_cutoff(op)``, so a warp whose pixels miss the box skips
    the instance. ``seq_box`` in ``csrc/blend_seq_common.cuh`` computes the
    same and states the error bound in both associations; the box is the
    whole plane where that bound does not hold
    (B^2 > 0.998 AC, det <= 0, a mean past 2^20, a NaN cutoff) and empty
    where no pair can blend (a cutoff >= 0)."""
    cut = alpha_floor_cutoff(op)
    inf = torch.full_like(cut, math.inf)
    ac = ca * cc
    det = ac - cbc * cbc
    ok = ((ca > 0) & (cc > 0) & (cbc * cbc <= 0.998 * ac) & (det > 0)
          & (mx.abs() < 2.0 ** 20) & (my.abs() < 2.0 ** 20) & (cut < 0))
    r2 = -2.0 * cut * (1.0 + 2.0 ** -10)
    hx = torch.sqrt(r2 * cc / det) * (1.0 + 2.0 ** -10) + 1.0
    hy = torch.sqrt(r2 * ca / det) * (1.0 + 2.0 ** -10) + 1.0
    box = torch.stack([torch.where(ok, mx - hx, -inf),
                       torch.where(ok, mx + hx, inf),
                       torch.where(ok, my - hy, -inf),
                       torch.where(ok, my + hy, inf)])
    empty = torch.stack([inf, -inf, inf, -inf])
    return torch.where(cut >= 0, empty, box)


def stage_cutoff_box(packed: torch.Tensor) -> torch.Tensor:
    """(5, K) float32: each instance's cutoff and box (x_lo, x_hi, y_lo,
    y_hi), as K1, K2, K4 and K5 stage the (9, K) table. On a CUDA tensor it
    launches ``csrc/blend_seq_stage.cu``, which runs the kernels' own
    ``seq_cutoff`` and ``seq_box``; on a CPU tensor it returns
    ``alpha_floor_cutoff`` and ``instance_box``, their PyTorch versions.
    Not a kernel of the render: the card tests and ``chip_smoke.py`` read
    it."""
    if packed.dtype != torch.float32 or packed.dim() != 2 \
            or packed.shape[0] != 9:
        raise ValueError("packed must be (9, K) float32, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if not _build.on_cuda("blend_seq_stage", (packed,)):
        return torch.cat([alpha_floor_cutoff(packed[5])[None],
                          instance_box(*packed[:6])])
    out = torch.empty((5, packed.shape[1]), dtype=torch.float32,
                      device=packed.device)
    _build.launch("blend_seq_stage", _STAGE_ARGS, packed.device,
                  packed.data_ptr(), packed.shape[1], out.data_ptr())
    return out


def blend_pair_counts(packed: torch.Tensor, tile_start: torch.Tensor,
                      tile_count: torch.Tensor, tiles_x: int, block_x: int,
                      block_y: int, raw: torch.Tensor,
                      association: str = "seq") -> dict:
    """The (instance, pixel) pairs that a blend forward (K1, K4) and its
    backward (K2, K5) need, at any tile shape, for their bounds.

    ``raw`` is the forward's (T, 5, block_x * block_y) output with
    n_contrib tracked; the cutoffs and boxes are the kernels' own
    (``stage_cutoff_box``), the power is rounded in ``association``
    (``blend_power``). A pixel visits (forward) each pair up to the one that
    makes it done, the first after its n_contrib whose a is nonzero; the
    backward walks each pixel's pairs before its own n_contrib. Of those:
    ``*_box``, the pixel inside the instance's box (they need the power);
    ``*_cols`` and ``*_rows``, the (instance, pixel column) and (instance,
    pixel row) pairs of a tile with at least one ``*_box`` pair (the terms
    of the power in dx alone, or dy alone, are needed once per column or
    row); ``*_live``, power in [cutoff, 0] (they need alpha); ``*_staged``,
    instances of a tile up to the last one any pixel needs. ``visited`` is
    every pair the forward visits, ``walked`` every pair the backward walks,
    ``blended`` the blended pairs: the first and the last equal the plain
    versions' ``return_pairs`` counts. Runs in chunks of instance indices,
    vectorised over (tiles x chunk x pixels), on ``packed``'s device.
    """
    dev = packed.device
    stage = stage_cutoff_box(packed)
    num_tiles = tile_count.numel()
    pix = block_x * block_y
    px, py = tile_pixel_coords(tiles_x, num_tiles // tiles_x, block_x,
                               block_y, dev)
    px, py = px[:, None], py[:, None]                    # (T, 1, PIX)
    start, count = tile_start.long(), tile_count.long()
    last = raw[:, 4].long()[:, None]                     # n_contrib
    done = torch.zeros((num_tiles, pix), dtype=torch.bool, device=dev)
    keys = ("fwd_box", "fwd_cols", "fwd_rows", "fwd_live", "fwd_staged",
            "bwd_box", "bwd_cols", "bwd_rows", "bwd_live", "bwd_staged",
            "visited", "walked", "blended")
    n = dict.fromkeys(keys, 0)
    chunk = max(1, (1 << 24) // max(1, num_tiles * pix))
    for i0 in range(0, int(count.max()) if num_tiles else 0, chunk):
        i = torch.arange(i0, i0 + chunk, device=dev)
        inrange = i[None] < count[:, None]               # (T, C)
        col = torch.where(inrange, start[:, None] + i[None], 0)
        mx, my, ca, cbc, cc, op = packed[:6, col, None]  # (T, C, 1)
        cut, x_lo, x_hi, y_lo, y_hi = stage[:, col, None]
        power = blend_power(mx - px, my - py, ca, cbc, cc, association)
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        nonzero = ((power <= 0.0) & (alpha >= ALPHA_MIN)
                   & inrange[..., None])                 # a > 0
        box = ((px >= x_lo) & (px <= x_hi) & (py >= y_lo) & (py <= y_hi)
               & inrange[..., None])
        live = ~(power < cut) & (power <= 0.0) & inrange[..., None]
        before = i[None, :, None] < last                 # (T, C, PIX)
        hit = nonzero & ~before                          # makes it done
        prior = hit.cumsum(dim=1) - hit.long()
        visit = inrange[..., None] & ~done[:, None] & (prior == 0)
        done |= hit.any(dim=1)
        walk = before & inrange[..., None]
        for side, need in (("fwd", visit), ("bwd", walk)):
            grid = (need & box).view(num_tiles, chunk, block_y, block_x)
            for key, mask in (("box", grid), ("cols", grid.any(dim=2)),
                              ("rows", grid.any(dim=3)),
                              ("live", need & live),
                              ("staged", need.any(dim=2))):
                n[f"{side}_{key}"] += int(mask.sum())
        for key, mask in (("visited", visit), ("walked", walk),
                          ("blended", nonzero & before)):
            n[key] += int(mask.sum())
    return n


def _check_inputs(packed, tile_start, tile_count, tiles_x, *per_tile):
    """Validate the kernels' common inputs; ``per_tile`` are (name, tensor)
    pairs that must be (T, 5, 1024) float32 on ``packed``'s device."""
    check_blend_inputs(packed, tile_start, tile_count, tiles_x, PIX,
                       *per_tile)


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
    if not _build.on_cuda("blend_seq_fwd", (packed, tile_start, tile_count),
                          "blend_tiles_seq"):
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
    _check_inputs(packed, tile_start, tile_count, tiles_x, ("raw", raw),
                  ("cot", cot))
    if not _build.on_cuda("blend_seq_bwd",
                          (packed, tile_start, tile_count, raw, cot),
                          "blend_tiles_seq"):
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
    _check_inputs(packed, tile_start, tile_count, tiles_x)
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
    _check_inputs(packed, tile_start, tile_count, tiles_x, ("raw", raw),
                  ("cot", cot))
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


class _SeqBlend(torch.autograd.Function):
    """K1 forward, K2 backward: the JAX ``custom_vjp`` of ``blend_tiles_seq``
    (raw outputs in, per-slot gradient rows out, masked by ``valid``)."""

    @staticmethod
    def forward(ctx, packed, tile_start, tile_count, valid, tiles_x,
                track_contrib):
        raw = blend_seq_fwd(packed, tile_start, tile_count, tiles_x,
                            track_contrib)
        ctx.save_for_backward(packed, raw, tile_start, tile_count, valid)
        ctx.tiles_x = tiles_x
        ctx.track_contrib = track_contrib
        return raw

    @staticmethod
    def backward(ctx, cot):
        packed, raw, tile_start, tile_count, valid = ctx.saved_tensors
        grad = blend_seq_bwd(packed, tile_start, tile_count, raw,
                             cot.contiguous(), ctx.tiles_x, ctx.track_contrib)
        grad = torch.where(valid[None, :], grad, 0.0)
        return grad, None, None, None, None, None


def blend_tiles_seq(inst: Instances, means2d: torch.Tensor,
                    conic: torch.Tensor, opacity: torch.Tensor,
                    rgb: torch.Tensor, tiles_x: int, tiles_y: int,
                    block_x: int, block_y: int, max_per_tile: int,
                    chunk: int = CHUNK,
                    track_contrib: bool = True) -> BlendResult:
    """Same contract as ``blend.blend_tiles``, through K1 (and K2 for the
    gradient) on a CUDA device.

    Takes 32x32 tiles and chunk 128 only (ValueError otherwise);
    ``max_per_tile`` is already applied by binning.
    """
    del max_per_tile
    if (block_x, block_y) != (BX, BY) or chunk != CHUNK:
        raise ValueError(
            f"the seq blend takes {BX}x{BY} tiles and {CHUNK}-wide chunks, "
            f"got {block_x}x{block_y} tiles, chunk {chunk}")
    if inst.tile_start.shape[0] != tiles_x * tiles_y:
        raise ValueError(f"{inst.tile_start.shape[0]} tiles binned, "
                         f"{tiles_x * tiles_y} expected")
    packed = pack_gather(pack_instance_attrs_t(means2d, conic, opacity, rgb),
                         inst.gid)
    raw = _SeqBlend.apply(packed, inst.tile_start, inst.tile_count,
                          inst.valid, tiles_x, track_contrib)
    return BlendResult(color=raw[:, 0:3].transpose(1, 2),
                       final_t=raw[:, 3],
                       n_contrib=raw[:, 4].detach().to(torch.int32))
