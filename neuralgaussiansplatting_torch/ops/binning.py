"""Tile binning: per-Gaussian tile duplication, depth sort, per-tile ranges.

Port of ``ops/binning.py``. The contract is the same, field for field: every
Gaussian is duplicated into one instance per tile of its rect (optionally
culled per instance), instances are sorted by [tile | depth], and each
tile's run is re-packed into a segment aligned to the blend chunk, with
``max_per_tile`` and ``capacity`` caps and their monitors.

``bin_gaussians`` on CUDA tensors runs the binning kernels (one library,
``csrc/binning.cu``): an expansion whose work follows the kept instances, a
stable radix sort over the key's live bits and the ranges and re-pack, with
no host read; its ``Instances`` are the plain version's bits. ``ValueError``
for inputs the kernels do not take; never a fallback. ``launches`` counts
those calls. On CPU tensors it is the plain version,
``bin_gaussians_reference``, where the JAX package's TPU layout devices
(single-column scatter expansion, barrel-shift run gather, blocked cumsum)
become their plain equivalents: a ``searchsorted`` owner lookup, an index
gather and ``torch.cumsum``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops.preprocess import Preprocessed

_INT32_MAX = 2 ** 31 - 1
# the expansion's Gaussians a block, the sort's items a block and digit
# width (csrc/binning.cu refuses other values)
_GAUSSIANS_PER_BLOCK = 2048
_SORT_TILE = 2048
_RADIX_BITS = 8

launches = 0  # bin_gaussians calls that ran the kernels, since the caller
              # last set it to 0


class Instances(NamedTuple):
    """Depth-sorted, tile-partitioned Gaussian instances (static capacity K).

    Slots between ``tile_count`` and the segment end are padding with
    ``gid == N``.
    """

    gid: torch.Tensor             # (K,) int32 gaussian index (== N for padding)
    valid: torch.Tensor           # (K,) bool
    tile_start: torch.Tensor      # (T,) int32 aligned start offset per tile
    tile_count: torch.Tensor      # (T,) int32 effective instance count per tile
    num_rendered: torch.Tensor    # () int32 true demand (may exceed K)
    max_tile_load: torch.Tensor   # () int32 max true per-tile demand
    aligned_demand: torch.Tensor  # () int32 aligned packed-buffer demand
    eid: torch.Tensor             # (K,) int32 kept-rank of each packed slot
                                  # (== expansion domain size for padding)
    gstart: torch.Tensor          # (N,) int32 kept-run start per gaussian
    gcount: torch.Tensor          # (N,) int32 kept-run length per gaussian
    dropped: torch.Tensor         # () int32 kept instances lost to caps
    culled: torch.Tensor          # () int32 instances removed by the exact
                                  # per-instance coverage test


def _expand_runs(fields: torch.Tensor, starts: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """Expand per-run constant rows to per-slot rows.

    ``fields`` (R, F) int32 holds one row per run, ``starts`` (R,) int32
    the runs' first slots, non-decreasing and >= 0. Slot s of the (capacity,
    F) int32 result holds the row of the last run r with starts[r] <= s, or
    zeros before the first start; starts at or past ``capacity`` are
    dropped and zero-length runs absorbed. The JAX package scatters the row
    differences at the starts and takes a blocked cumsum (int32 wraparound
    telescopes exactly); this is the same contract as an owner lookup and a
    row gather.
    """
    slots = torch.arange(capacity, dtype=starts.dtype, device=starts.device)
    owner = torch.searchsorted(starts, slots, right=True)   # = last owner + 1
    rows = torch.cat([fields.new_zeros((1,) + fields.shape[1:]), fields])
    return rows[owner]


def bin_gaussians(pre: Preprocessed, tiles_x: int, tiles_y: int,
                  capacity: int, max_per_tile: int, align: int,
                  pack_keys: bool = False,
                  packed_capacity: int | None = None,
                  precise_cull: bool = False,
                  block_x: int = 16, block_y: int = 16,
                  width: int | None = None,
                  height: int | None = None,
                  expand: str = "scatter",
                  dense_cap: int = 16) -> Instances:
    """Expand Gaussians into depth-sorted, chunk-aligned per-tile instances:
    the binning kernels for CUDA tensors, the plain version
    (``bin_gaussians_reference``, whose docstring gives the options) for
    CPU tensors."""
    if expand not in ("scatter", "dense"):
        raise ValueError(f"expand must be 'scatter' or 'dense', got {expand!r}")
    width = tiles_x * block_x if width is None else width
    height = tiles_y * block_y if height is None else height
    dev = pre.tiles_touched.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no binning kernels for device {dev}")
    if dev.type == "cpu":
        return bin_gaussians_reference(
            pre, tiles_x, tiles_y, capacity, max_per_tile, align,
            pack_keys=pack_keys, packed_capacity=packed_capacity,
            precise_cull=precise_cull, block_x=block_x, block_y=block_y,
            width=width, height=height, expand=expand, dense_cap=dense_cap)
    return _bin_on_card(pre, tiles_x, tiles_y, capacity, max_per_tile, align,
                        pack_keys, packed_capacity, precise_cull, block_x,
                        block_y, width, height, expand, dense_cap)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_BINNING_ARGS = (_P,) * 7 + (_LL,) + (_I,) * 6 + (_LL,) + (_I,) * 6 \
    + (_LL, _I, _I, _LL, _I, _I) + (_P,) * 19 + (_P,)
_SORT_ARGS = (_P,) * 7 + (_LL,) + (_I,) * 4 + (_P,)


def _card_input(t: torch.Tensor, name: str, dtype: torch.dtype,
                shape: tuple, device: torch.device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"the binning kernels take {name} as {shape} "
                         f"{dtype}, got {tuple(t.shape)} {t.dtype}")
    return t.detach().contiguous()


def card_inputs(pre: Preprocessed, precise_cull: bool) -> tuple:
    """(tiles_touched, rect_min, rect_max, depths, conic, opacity, means2d)
    as the kernels read them: detached, contiguous, on ``tiles_touched``'s
    device, int32 / float32 of the plain version's shapes; the last three
    are None without ``precise_cull``, which alone reads them. Raises
    ``ValueError`` otherwise."""
    dev = pre.tiles_touched.device
    n = pre.tiles_touched.shape[0]
    i32, f32 = torch.int32, torch.float32
    want = [("tiles_touched", i32, (n,)), ("rect_min", i32, (n, 2)),
            ("rect_max", i32, (n, 2)), ("depths", f32, (n,))]
    if precise_cull:
        want += [("conic", f32, (n, 3)), ("opacity", f32, (n,)),
                 ("means2d", f32, (n, 2))]
    out = [_card_input(getattr(pre, name), name, dtype, shape, dev)
           for name, dtype, shape in want]
    return tuple(out) + (None,) * (7 - len(out))


def key_layout(num_tiles: int, pack_keys: bool) -> tuple[int, int]:
    """(bits, tile shift) of the kernels' sort key, (tile << shift) +
    (depth_bits >> (31 - shift)): the exact key over the tiles' bits above
    31 depth bits, or the packed 31-bit key."""
    if pack_keys:
        return 31, 31 - max(int(num_tiles + 1).bit_length(), 1)
    return 31 + int(num_tiles - 1).bit_length(), 31


def sort_passes(bits: int) -> int:
    """The radix sort's passes for a key of ``bits`` bits."""
    return -(-bits // _RADIX_BITS)


def _sort_buffers(keys: torch.Tensor) -> tuple:
    """The sort's second key buffer, its two value buffers ((2, domain)
    int32), its per-(digit, block) counts and its digit totals, for
    ``keys``."""
    domain = keys.shape[-1]
    counts_len = (1 << _RADIX_BITS) * -(-domain // _SORT_TILE)
    scratch = torch.empty(2 * domain + counts_len + (1 << _RADIX_BITS),
                          dtype=torch.int32, device=keys.device)
    return (torch.empty_like(keys), scratch[:2 * domain].view(2, domain),
            scratch[2 * domain:2 * domain + counts_len],
            scratch[2 * domain + counts_len:])


def radix_sort(keys: torch.Tensor, live: torch.Tensor,
               bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The binning kernels' sort alone (``csrc/binning.cu``'s
    ``radix_sort``): the first ``live[0]`` of ``keys`` (a device int32,
    (1,)) sorted by their low ``bits`` bits, read as unsigned, stably;
    returns (sorted keys, their indices as int32), each as long as ``keys``
    (int64 or int32, 1-D, contiguous), with unspecified entries past
    ``live[0]``. Clobbers ``keys``."""
    dev, domain = keys.device, keys.shape[0]
    if keys.dtype not in (torch.int32, torch.int64) or keys.dim() != 1 \
            or not 1 <= domain <= _INT32_MAX or not keys.is_contiguous() \
            or live.dtype != torch.int32 or live.device != dev:
        raise ValueError("radix_sort takes contiguous 1-D int32 or int64 "
                         "keys (at most 2^31 - 1) and an int32 count on "
                         "their device")
    passes = sort_passes(bits)
    other, vals, counts, totals = _sort_buffers(keys)
    _build.launch(
        "radix_sort", _SORT_ARGS, dev, keys.data_ptr(), other.data_ptr(),
        vals[0].data_ptr(), vals[1].data_ptr(), counts.data_ptr(),
        totals.data_ptr(), live.data_ptr(), domain, bits,
        int(keys.dtype == torch.int64), passes, _SORT_TILE,
        library="binning")
    return (keys, vals[0]) if passes % 2 == 0 else (other, vals[1])


def _bin_on_card(pre, tiles_x, tiles_y, capacity, max_per_tile, align,
                 pack_keys, packed_capacity, precise_cull, block_x, block_y,
                 width, height, expand, dense_cap) -> Instances:
    global launches
    dev = pre.tiles_touched.device
    n = pre.tiles_touched.shape[0]
    num_tiles = tiles_x * tiles_y
    dense = expand == "dense"
    domain = n * dense_cap if dense else capacity
    kcap = capacity if packed_capacity is None else packed_capacity
    if not (1 <= n < _INT32_MAX and 1 <= num_tiles < _INT32_MAX
            and 1 <= domain <= _INT32_MAX and 1 <= kcap <= _INT32_MAX
            and dense_cap >= 1 and align >= 1):
        raise ValueError(
            f"the binning kernels take 1 <= n, tiles < 2^31, an expansion "
            f"domain and a packed capacity in [1, 2^31), dense_cap >= 1 and "
            f"align >= 1; got n {n}, {num_tiles} tiles, domain {domain}, "
            f"packed capacity {kcap}, dense_cap {dense_cap}, align {align}")
    ins = card_inputs(pre, precise_cull)
    bits, tile_shift = key_layout(num_tiles, pack_keys)
    i32 = torch.int32
    blocks = -(-n // _GAUSSIANS_PER_BLOCK)
    parts = torch.empty(3 * blocks + 4, dtype=torch.int64, device=dev)
    keys = torch.empty(domain, dtype=i32 if pack_keys else torch.int64,
                       device=dev)
    other, vals, counts, totals = _sort_buffers(keys)
    small = torch.empty(domain + num_tiles + 2, dtype=i32, device=dev)
    gid_of, tile_lo, live = small[:domain], small[domain:-1], small[-1:]
    gstart, gcount = torch.empty((2, n), dtype=i32, device=dev)
    tile_start, tile_count = torch.empty((2, num_tiles), dtype=i32,
                                         device=dev)
    gid, eid = torch.empty((2, kcap), dtype=i32, device=dev)
    valid = torch.empty(kcap, dtype=torch.bool, device=dev)
    monitors = torch.empty(5, dtype=i32, device=dev)
    _build.launch(
        "binning", _BINNING_ARGS, dev,
        *(None if t is None else t.data_ptr() for t in ins), n, tiles_x,
        tiles_y, block_x, block_y, width, height, capacity, int(dense),
        dense_cap, int(precise_cull), int(not pack_keys), tile_shift, bits,
        kcap, min(max_per_tile, _INT32_MAX), align, domain,
        _GAUSSIANS_PER_BLOCK, _SORT_TILE,
        *(t.data_ptr() for t in (
            parts[:-4], parts[-4:], live, keys, other, vals[0], vals[1],
            counts, totals, gid_of, tile_lo, gcount, gstart, tile_start,
            tile_count, gid, valid, eid, monitors)))
    launches += 1
    num_rendered, max_tile_load, aligned_demand, dropped, culled = \
        monitors.unbind()
    return Instances(gid=gid, valid=valid, tile_start=tile_start,
                     tile_count=tile_count, num_rendered=num_rendered,
                     max_tile_load=max_tile_load,
                     aligned_demand=aligned_demand, eid=eid, gstart=gstart,
                     gcount=gcount, dropped=dropped, culled=culled)


def bin_gaussians_reference(pre: Preprocessed, tiles_x: int, tiles_y: int,
                            capacity: int, max_per_tile: int, align: int,
                            pack_keys: bool = False,
                            packed_capacity: int | None = None,
                            precise_cull: bool = False,
                            block_x: int = 16, block_y: int = 16,
                            width: int | None = None,
                            height: int | None = None,
                            expand: str = "scatter",
                            dense_cap: int = 16) -> Instances:
    """The plain version: expand Gaussians into depth-sorted, chunk-aligned
    per-tile instances.

    ``pack_keys``: sort on one [tile | quantized depth] key that keeps the
    top (31 - bit_length(T+1)) depth bits; nearly coincident splats may swap
    order against the exact two-key sort.

    ``packed_capacity``: size of the aligned output buffer (default
    ``capacity``, the size of the expansion/sort domain).

    ``expand``: "scatter" (runs of instances over a ``capacity``-slot domain;
    instances past it are truncated and counted) or "dense" (every Gaussian
    owns ``dense_cap`` slots; instances past the cap are dropped and
    counted).

    ``precise_cull``: drop instances whose tile lies wholly outside the
    alpha >= 1/255 ellipse, by a separating-axis test along the two
    diagonals (image-exact). In "scatter" mode the diagonal support
    intervals are quantized outward to a 0.25 px grid, as the JAX package
    does; ``eid``/``gstart``/``gcount`` are then over the kept instances.
    """
    if expand not in ("scatter", "dense"):
        raise ValueError(f"expand must be 'scatter' or 'dense', got {expand!r}")
    dev = pre.tiles_touched.device
    n = pre.tiles_touched.shape[0]
    num_tiles = tiles_x * tiles_y
    width = tiles_x * block_x if width is None else width
    height = tiles_y * block_y if height is None else height

    tiles_touched = pre.tiles_touched.long()
    offsets = torch.cumsum(tiles_touched, 0)          # inclusive prefix sum
    num_rendered = offsets[-1]
    starts = offsets - tiles_touched                  # exclusive prefix sum

    rect_x0 = pre.rect_min[:, 0].long()
    rect_y0 = pre.rect_min[:, 1].long()
    rect_w = torch.clamp_min(pre.rect_max[:, 0].long() - rect_x0, 1)
    depth_bits = pre.depths.float().view(torch.int32).long()  # > 0 => monotone

    if precise_cull:
        # Diagonal support intervals of the alpha >= 1/255 ellipse:
        # conic = [[A, B], [B, C]], u^T Sigma u = (A + C -+ 2B) / det for
        # u = (1, +-1).
        ca, cb, cc = pre.conic[:, 0], pre.conic[:, 1], pre.conic[:, 2]
        det = ca * cc - cb * cb
        safe_det = torch.where(det > 0, det, 1.0)
        lvl = torch.log(torch.clamp_min(pre.opacity, 1e-12) * 255.0)
        lvl = torch.clamp_min(lvl, 0.0)   # opacity < 1/255 => zero support
        r1 = torch.sqrt(torch.clamp_min(
            2.0 * lvl * (ca + cc - 2.0 * cb) / safe_det, 0.0))
        r2 = torch.sqrt(torch.clamp_min(
            2.0 * lvl * (ca + cc + 2.0 * cb) / safe_det, 0.0))
        s1 = pre.means2d[:, 0] + pre.means2d[:, 1]
        s2 = pre.means2d[:, 0] - pre.means2d[:, 1]

    def cull_keep(tx, ty, lo1, hi1, lo2, hi2):
        # the tile's pixel-centre rect, clipped to the image
        x0 = (tx * block_x).float()
        y0 = (ty * block_y).float()
        x1 = torch.clamp_max(tx * block_x + (block_x - 1), width - 1).float()
        y1 = torch.clamp_max(ty * block_y + (block_y - 1), height - 1).float()
        return ((lo1 <= x1 + y1) & (hi1 >= x0 + y0)
                & (lo2 <= x1 - y0) & (hi2 >= x0 - y1))

    if expand == "dense":
        m = dense_cap
        domain = n * m
        j = torch.arange(m, device=dev)[None, :]
        in_range = j < torch.clamp_max(tiles_touched, m)[:, None]
        rw = rect_w[:, None]
        tx = rect_x0[:, None] + j % rw
        ty = rect_y0[:, None] + j // rw
        trunc = torch.clamp_min(tiles_touched - m, 0).sum()
        if precise_cull:
            keep = in_range & cull_keep(
                tx, ty, (s1 - r1)[:, None], (s1 + r1)[:, None],
                (s2 - r2)[:, None], (s2 + r2)[:, None])
            keep_i = keep.long()
            gcount_eff = keep_i.sum(dim=1)
            cg = torch.cumsum(gcount_eff, 0)
            kept_total = cg[-1]
            gstart_eff = cg - gcount_eff
            # kept rank = per-Gaussian base + within-row kept prefix
            eid_new = gstart_eff[:, None] + torch.cumsum(keep_i, 1) - keep_i
        else:
            keep = in_range
            gcount_eff = torch.clamp_max(tiles_touched, m)
            ck = torch.cumsum(gcount_eff, 0)
            kept_total = ck[-1]
            gstart_eff = ck - gcount_eff
            eid_new = gstart_eff[:, None] + j
        keep, tx, ty, eid_new = (a.reshape(domain)
                                 for a in (keep, tx, ty, eid_new))
        depth = depth_bits[:, None].expand(n, m).reshape(domain)
        gid = torch.arange(n, device=dev)[:, None].expand(n, m).reshape(domain)
    else:
        domain = capacity
        slots = torch.arange(capacity, device=dev)
        # owner of slot s: the last Gaussian whose run starts at or before s
        gid = torch.searchsorted(starts[1:].contiguous(), slots, right=True)
        in_range = slots < num_rendered
        local = slots - starts[gid]
        rw = rect_w[gid]
        tx = rect_x0[gid] + local % rw
        ty = rect_y0[gid] + local // rw
        if precise_cull:
            # Outward quantization to an absolute 0.25 px grid, clamped to
            # +-8192 px (clamping only widens the interval). The grid is
            # absolute so that strip renders shifted by whole tiles make the
            # same cull decisions as the full frame.
            span, qscale = 8192.0, 0.25

            def quantize(lo, hi):
                lo_q = torch.clamp(torch.floor((lo + span) / qscale), 0, 65535)
                hi_q = torch.clamp(torch.ceil((hi + span) / qscale), 0, 65535)
                return lo_q * qscale - span, hi_q * qscale - span

            lo1, hi1 = quantize(s1 - r1, s1 + r1)
            lo2, hi2 = quantize(s2 - r2, s2 + r2)
            keep = in_range & cull_keep(tx, ty, lo1[gid], hi1[gid],
                                        lo2[gid], hi2[gid])
            keep_i = keep.long()
            kept_incl = torch.cumsum(keep_i, 0)
            eid_new = kept_incl - keep_i
            kept_total = kept_incl[-1]
            # runs stay contiguous under culling: each Gaussian's kept run
            # is the kept prefix read at its raw run boundaries
            pfx = torch.cat([kept_incl.new_zeros(1), kept_incl])
            gstart_eff = pfx[torch.clamp_max(starts, capacity)]
            gcount_eff = pfx[torch.clamp_max(offsets, capacity)] - gstart_eff
        else:
            keep = in_range
            eid_new = slots
            kept_total = torch.clamp_max(num_rendered, capacity)
            gstart_eff = torch.clamp_max(starts, capacity)
            gcount_eff = torch.clamp_max(offsets, capacity) - gstart_eff
        depth = depth_bits[gid]
        trunc = torch.clamp_min(num_rendered - capacity, 0)

    tile = torch.where(keep, ty * tiles_x + tx, num_tiles)
    gid_slot = torch.where(keep, gid, n)
    eid_slot = torch.where(keep, eid_new, domain)

    # --- (tile, depth) lexicographic sort; ties keep expansion order -------
    if pack_keys:
        tile_bits = max(int(num_tiles + 1).bit_length(), 1)
        depth_bits_kept = 31 - tile_bits
        key = torch.where(keep, tile * (1 << depth_bits_kept)
                          + (depth >> tile_bits), _INT32_MAX)
        sorted_key, perm = torch.sort(key, stable=True)
        sorted_tile = torch.where(sorted_key == _INT32_MAX, num_tiles,
                                  sorted_key >> depth_bits_kept)
    else:
        # kept depths are positive floats (z > 0.2), so their bits fit 31
        dkey = torch.where(keep, depth, _INT32_MAX)
        _, perm = torch.sort(tile * (1 << 32) + dkey, stable=True)
        sorted_tile = tile[perm]
    sorted_gid = gid_slot[perm]
    sorted_e = eid_slot[perm]

    tile_ids = torch.arange(num_tiles, device=dev)
    raw_start = torch.searchsorted(sorted_tile, tile_ids, right=False)
    raw_end = torch.searchsorted(sorted_tile, tile_ids, right=True)
    raw_count = raw_end - raw_start

    # --- aligned re-pack ---------------------------------------------------
    kcap = capacity if packed_capacity is None else packed_capacity
    count_eff = torch.clamp_max(raw_count, max_per_tile)
    seg = (count_eff + align - 1) // align * align
    seg_end = torch.cumsum(seg, 0)
    aligned_demand = seg_end[-1]
    drop = seg_end > kcap              # conservative whole-tile drop
    count_eff = torch.where(drop, 0, count_eff)
    seg = torch.where(drop, 0, seg)
    seg_end = torch.cumsum(seg, 0)
    aligned_start = seg_end - seg
    total = seg_end[-1]

    kslots = torch.arange(kcap, device=dev)
    # owner tile of each packed slot: the last tile whose segment starts at
    # or before it (empty segments share their start with the next tile)
    owner = torch.searchsorted(aligned_start, kslots, right=True) - 1
    src = kslots + (raw_start - aligned_start)[owner]
    valid = (kslots < total) & (src < (raw_start + count_eff)[owner])
    src = torch.clamp(src, 0, domain - 1)
    i32 = torch.int32
    return Instances(
        gid=torch.where(valid, sorted_gid[src], n).to(i32),
        valid=valid,
        tile_start=aligned_start.to(i32),
        tile_count=count_eff.to(i32),
        num_rendered=num_rendered.to(i32),
        max_tile_load=raw_count.max().to(i32),
        aligned_demand=aligned_demand.to(i32),
        eid=torch.where(valid, sorted_e[src], domain).to(i32),
        gstart=gstart_eff.to(i32),
        gcount=gcount_eff.to(i32),
        dropped=(kept_total + trunc - count_eff.sum()).to(i32),
        culled=(num_rendered - trunc - kept_total).to(i32),
    )
