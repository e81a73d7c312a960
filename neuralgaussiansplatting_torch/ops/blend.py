"""The blend layer's shared base: what the blend routes and the neural
z-buffer have in common.

Port of ``ops/blend.py`` and of what more than one route uses of
``ops/blend_seq.py`` and ``ops/blend_pallas.py``: the blend's contract
(``BlendResult``, the constants, ``tile_pixel_coords``, ``assemble_image``);
the packed table the kernel routes read (``pack_instance_attrs_t``,
``pack_gather``) and its per-Gaussian sum (``sum_rows_by_id``,
``reduce_by_gaussian``); the kernels' input check (``check_blend_inputs``);
the rules by which the four blend kernels skip work (``blend_power``,
``alpha_floor_cutoff``, ``instance_box``, ``stage_cutoff_box``) and the
counter of the pairs they need (``blend_pair_counts``); and the
``backend="xla"`` oracle ``blend_tiles``.

The packed table has one column per Gaussian plus an all-zero sentinel
column at index N: padding instances carry ``gid == N``, so they read zeros
(opacity 0 => alpha 0) and every blend update they make is a no-op. The
gradient of ``pack_gather`` sums each Gaussian's per-slot gradient rows: a
stable sort of the slots by ``gid``, then a sum over each Gaussian's run of
slots in slot order. That is exact over the slots present, whether or not
binning dropped instances (what the JAX package's ``grad_reduce`` modes
reach through two sort variants and a scatter), and it repeats bit for bit:
no atomics. The JAX package's cumsum-difference reduction is a TPU layout
device and is not ported.

``blend_tiles`` is the plain scan, plain PyTorch on any device and
differentiable by autograd. Every tile is blended at once as dense
(T, CHUNK, PIX) math in a loop over depth chunks; the front-to-back product
is a cumulative product along the chunk axis. An instance contributes iff
the running transmittance after it stays >= 1e-4 and no earlier instance
already stopped the pixel; the crossing instance is not blended and T keeps
its last value >= 1e-4.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops.binning import Instances

STOP_T = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
# Packed row layout: 0:x 1:y 2:conic_A 3:conic_B 4:conic_C 5:opacity 6:r 7:g
# 8:b. (The TPU kernels pad these 9 rows to 16 sublanes; the CUDA kernels
# read and write the 9 rows directly.)
PROWS = 9
# the two float32 associations of the power: K1 and K2's ("seq") and K4 and
# K5's, the JAX pallas kernel's ("pallas")
ASSOCIATIONS = ("seq", "pallas")
# the C signature of csrc/blend_stage.cu (the last pointer is the stream)
_STAGE_ARGS = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
               ctypes.c_void_p)


class BlendResult(NamedTuple):
    color: torch.Tensor      # (T, PIX, 3) pre-background composited color
    final_t: torch.Tensor    # (T, PIX) final transmittance
    n_contrib: torch.Tensor  # (T, PIX) int32 1-based index of last blend


def tile_pixel_coords(tiles_x: int, tiles_y: int, block_x: int, block_y: int,
                      device):
    """(T, PIX) pixel x/y coordinates (integer pixel positions) per tile."""
    t = torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=device)
    tx = (t % tiles_x)[:, None]
    ty = (t // tiles_x)[:, None]
    j = torch.arange(block_x * block_y, dtype=torch.int32, device=device)[None, :]
    px = (tx * block_x + j % block_x).float()
    py = (ty * block_y + j // block_x).float()
    return px, py


def compute_alpha(xy, con, op, px, py):
    """Masked alpha of instances against pixels.

    xy: (..., 2), con: (..., 3), op: (...,) broadcast against px/py
    (..., PIX). Applies the power > 0 / alpha < 1/255 cutoffs and the 0.99
    clamp.
    """
    dx = xy[..., 0:1] - px
    dy = xy[..., 1:2] - py
    a, b, c = con[..., 0:1], con[..., 1:2], con[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(op[..., None] * torch.exp(power), ALPHA_MAX)
    return torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, 0.0)


def blend_tiles(
    inst: Instances,
    means2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    rgb: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    block_x: int,
    block_y: int,
    max_per_tile: int,
    chunk: int = 32,
) -> BlendResult:
    """Blend all tiles front-to-back over at most ``max_per_tile`` instances."""
    dev = means2d.device
    num_tiles = tiles_x * tiles_y
    pix = block_x * block_y
    n = means2d.shape[0]
    capacity = inst.gid.shape[0]
    n_chunks = (max_per_tile + chunk - 1) // chunk

    px, py = tile_pixel_coords(tiles_x, tiles_y, block_x, block_y, dev)
    px, py = px[:, None, :], py[:, None, :]
    lanes = torch.arange(chunk, device=dev)[None, :]
    t_in = torch.ones((num_tiles, pix), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, pix), dtype=torch.bool, device=dev)
    color = torch.zeros((num_tiles, pix, 3), dtype=torch.float32, device=dev)
    last = torch.zeros((num_tiles, pix), dtype=torch.int64, device=dev)
    for c in range(n_chunks):
        local = c * chunk + lanes                                   # (1, CH)
        in_tile = local < inst.tile_count[:, None]                  # (T, CH)
        pos = torch.clamp(inst.tile_start[:, None] + local, 0, capacity - 1)
        g = torch.clamp(inst.gid[pos].long(), 0, n - 1)             # (T, CH)

        alpha = compute_alpha(means2d[g], conic[g], opacity[g], px, py)
        alpha = torch.where(in_tile[..., None], alpha, 0.0)         # (T, CH, P)

        cum = t_in[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)  # inclusive
        cum_excl = torch.cat([t_in[:, None, :], cum[:, :-1, :]], dim=1)
        alive = (cum >= STOP_T) & ~done[:, None, :]
        contrib = torch.where(alive, alpha * cum_excl, 0.0)
        color = color + torch.einsum("tcp,tck->tpk", contrib, rgb[g])
        t_in = torch.where(alive, cum, t_in[:, None, :]).amin(dim=1)
        done = done | (cum < STOP_T).any(dim=1)
        blended = alive & (alpha > 0.0)
        last = torch.maximum(
            last, torch.where(blended, local[..., None] + 1, 0).amax(dim=1))
    return BlendResult(color=color, final_t=t_in,
                       n_contrib=last.to(torch.int32))


def assemble_image(per_tile: torch.Tensor, tiles_x: int, tiles_y: int,
                   block_x: int, block_y: int, width: int, height: int) -> torch.Tensor:
    """(T, PIX, C) or (T, PIX) tile-major pixels -> (H, W[, C]) image crop."""
    squeeze = per_tile.ndim == 2
    if squeeze:
        per_tile = per_tile[..., None]
    c = per_tile.shape[-1]
    img = per_tile.reshape(tiles_y, tiles_x, block_y, block_x, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(
        tiles_y * block_y, tiles_x * block_x, c)
    img = img[:height, :width]
    return img[..., 0] if squeeze else img


def pack_instance_attrs_t(means2d, conic, opacity, rgb, *extra):
    """Per-Gaussian attrs -> (R, N + 1) float32 columns; the last column is
    the all-zero sentinel for padding instances. The rows are means2d's 2
    columns, ``conic``'s (3 for the blend kernels' conic, 9 for a surfel's
    transform), the opacity, rgb's 3 and then the columns of each of
    ``extra`` ((N,) or (N, C)): R = 9 for the conic and no extra."""
    cols = [means2d[:, 0], means2d[:, 1], *conic.unbind(1), opacity,
            rgb[:, 0], rgb[:, 1], rgb[:, 2]]
    for e in extra:
        cols += e.unbind(1) if e.dim() == 2 else [e]
    packed = torch.stack(cols, dim=0).float()          # (R, N)
    return torch.cat([packed, packed.new_zeros((packed.shape[0], 1))], dim=1)


def sum_rows_by_id(rows: torch.Tensor, ids: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(K, C) rows -> (n, C) sums of the rows of each id in [0, n).

    Rows with ``id == n`` (padding) are left out. Each id's rows are added
    in row order: a stable sort by id, then one sum per id's run, so the
    result repeats bit for bit (no atomics).
    """
    ids = ids.long()
    order = torch.argsort(ids, stable=True)
    starts = torch.searchsorted(ids[order],
                                torch.arange(n + 1, device=ids.device))
    # n segments [starts[g], starts[g + 1]); the padding run after
    # starts[n] is not one of them. unsafe=True skips validation that would
    # sync the host; the offsets are monotone and within [0, K].
    return torch.segment_reduce(rows[order], "sum", offsets=starts, axis=0,
                                unsafe=True)


def reduce_by_gaussian(cot: torch.Tensor, gid: torch.Tensor,
                       n: int) -> torch.Tensor:
    """(R, K) per-slot rows -> (R, n + 1) per-Gaussian sums, R the table's
    rows (9 for K1's, 18 for a surfel's).

    Slots with ``gid == n`` (padding) are left out, and column n (the
    sentinel) is zero. Each Gaussian's slots are added in slot order.
    """
    sums = sum_rows_by_id(cot.t(), gid, n)             # (n, R)
    return torch.cat([sums, sums.new_zeros((1, cot.shape[0]))]
                     ).t().contiguous()


class _PackGather(torch.autograd.Function):
    """Gather by ``gid`` forward; the per-Gaussian sum backward."""

    @staticmethod
    def forward(ctx, packed_all, gid):
        ctx.save_for_backward(gid)
        ctx.num_gaussians = packed_all.shape[1] - 1
        return packed_all[:, gid.long()].contiguous()

    @staticmethod
    def backward(ctx, cot):
        (gid,) = ctx.saved_tensors
        return reduce_by_gaussian(cot, gid, ctx.num_gaussians), None


def pack_gather(packed_all: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """(R, N + 1) packed table -> (R, K) per-instance columns by ``gid``,
    differentiable with respect to ``packed_all``, for any row count R."""
    return _PackGather.apply(packed_all, gid)


def check_blend_inputs(packed, tile_start, tile_count, tiles_x, pix,
                       *per_tile, rows: int = PROWS, channels: int = 5):
    """Validate the blend kernels' common inputs: ``packed`` (rows, K)
    float32; ``per_tile`` are (name, tensor) pairs that must be (T,
    channels, pix) float32 on ``packed``'s device."""
    if packed.dtype != torch.float32 or packed.ndim != 2 \
            or packed.shape[0] != rows:
        raise ValueError(f"packed must be ({rows}, K) float32, got "
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
    for name, a in per_tile:
        if (a.dtype != torch.float32
                or tuple(a.shape) != (num_tiles, channels, pix)):
            raise ValueError(f"{name} must be ({num_tiles}, {channels}, "
                             f"{pix}) float32, got {tuple(a.shape)} "
                             f"{a.dtype}")
        if a.device != packed.device:
            raise ValueError(f"{name} is on {a.device}, packed on "
                             f"{packed.device}")


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
    its ``expf``. ``alpha_cutoff`` in ``csrc/blend_common.cuh`` computes
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
    the instance. ``instance_box`` in ``csrc/blend_common.cuh`` computes the
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
    launches ``csrc/blend_stage.cu``, which runs the kernels' own
    ``alpha_cutoff`` and ``instance_box``; on a CPU tensor it returns
    ``alpha_floor_cutoff`` and ``instance_box``, their PyTorch versions.
    Not a kernel of the render: the card tests and ``chip_smoke.py`` read
    it."""
    if packed.dtype != torch.float32 or packed.dim() != 2 \
            or packed.shape[0] != 9:
        raise ValueError("packed must be (9, K) float32, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if not _build.on_cuda("blend_stage", (packed,)):
        return torch.cat([alpha_floor_cutoff(packed[5])[None],
                          instance_box(*packed[:6])])
    out = torch.empty((5, packed.shape[1]), dtype=torch.float32,
                      device=packed.device)
    _build.launch("blend_stage", _STAGE_ARGS, packed.device,
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
