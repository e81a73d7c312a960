"""Sub-stage bisection of binning and of the per-Gaussian gradient sum at
the 800^2 bench shape (the demo cloud of 100k Gaussians, SH degree 3,
preprocessed once at 16x16 tiles: 50x50 tiles, capacity 1216Ki, packed
1344Ki, 2048 per tile, alignment 128).

Port of ``tools/exp_binning_micro.py``: the same rows and names. The
"binning upto ..." rows run ``binning.bin_gaussians``' run-length path
(packed [tile | depth] key, no precise cull) cut at its own stage
boundaries (``binning_stages``), each row doing every stage up to its own:

  expand          the owner of each slot (``searchsorted`` over the runs'
                  starts), its tile from the rect and the slot's rank in
                  the run, its depth bits
  sort            the stable sort of the [tile | depth] keys
  ranges          each tile's run in the sorted order (``searchsorted``)
  repack_expand   each aligned packed slot's owner tile and source slot
  full            the gather of gid and eid into the packed slots

"full" gives what ``bin_gaussians`` returns. Then the gradient-sum rows on
the JAX tool's seeded synthetic rows (9 x 1344Ki normal cotangents, 1.13M
kept slots in a random order, per-Gaussian runs): "reduce sort-only" (the
stable sort of the slots by rank and the row gather) and "reduce full"
(``blend.reduce_by_gaussian``); "reduce drop-tolerant" has no
counterpart. ``variants`` runs the expand-stage variants instead: "ex only"
(``binning._expand_runs`` of the four packed per-Gaussian fields) and the
integer and float divisions of the packed rect, which have no counterpart
(``NO_COUNTERPART``), nor has the check that the two agree.

Timing: ``tools.chain_bench.chain``, 8 steps, best of 2. The JAX tool
chains inside one jit; here the steps run eagerly, so each figure is host
clock with the host's dispatch included (chained eager, host clock). No
kernel of the port runs here.

    python -m neuralgaussiansplatting_torch.tools.exp_binning_micro \\
        [variants]

``main(argv)`` returns the rows with "timing", "launches" and "device".
Runs on the CUDA device, or on the CPU when ``NGS_PLATFORM=cpu``.
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np
import torch

from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch.demo import demo_scene
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import blend
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.tools import _harness, _micro

W = H = 800
N = 100_000
CAPACITY = 1216 * 1024
KCAP = 1344 * 1024
ALIGN = 128
MAX_PER_TILE = 2048
BLOCK = 16
STAGES = ("expand", "sort", "ranges", "repack_expand", "full")
REDUCE_ROWS = ("reduce sort-only", "reduce full", "reduce drop-tolerant")
VARIANT_ROWS = ("ex only", "ex+intdiv", "ex+fdiv")
KEPT = 1_130_000     # the synthetic rows' kept slots
ITERS, REPS = 8, 2
NO_COUNTERPART = {
    "reduce drop-tolerant": "the drop-tolerant variant of the JAX "
                            "cumsum-difference reduce; the port's "
                            "per-Gaussian sum is exact with drops too",
    "ex+intdiv": "decodes the rect packed into one int32 field for the "
                 "TPU's single-column expansion; the port gathers each "
                 "Gaussian's rect directly",
    "ex+fdiv": "a float-division variant of that TPU packed-rect decode",
    "fdiv checksum match": "checks the two TPU decode variants against "
                           "each other",
}
_INT32_MAX = 2 ** 31 - 1


def preprocessed(params, state, cam) -> pp.Preprocessed:
    """The cloud preprocessed once at 16x16 tiles (tight rects)."""
    with torch.no_grad():
        return pp.preprocess_gaussians(
            params.xyz, gm.get_scaling(params), gm.get_rotation(params),
            gm.get_opacity(params, state.alive), gm.get_features(params), 3,
            cam, BLOCK, BLOCK, tight=True)


def binning_stages(pre: pp.Preprocessed, upto: str, tiles_x: int,
                   tiles_y: int, s: float = 0.0) -> dict:
    """``bin_gaussians(pre, tiles_x, tiles_y, CAPACITY, MAX_PER_TILE,
    ALIGN, pack_keys=True, packed_capacity=KCAP)`` done up to stage
    ``upto`` (one of ``STAGES``), its depths shifted by ``s``; returns the
    tensors that stage hands on."""
    dev = pre.tiles_touched.device
    n = pre.tiles_touched.shape[0]
    num_tiles = tiles_x * tiles_y
    tiles_touched = pre.tiles_touched.long()
    offsets = torch.cumsum(tiles_touched, 0)
    num_rendered = offsets[-1]
    starts = offsets - tiles_touched
    rect_x0 = pre.rect_min[:, 0].long()
    rect_y0 = pre.rect_min[:, 1].long()
    rect_w = torch.clamp_min(pre.rect_max[:, 0].long() - rect_x0, 1)
    depth_bits = (pre.depths + s).float().view(torch.int32).long()
    slots = torch.arange(CAPACITY, device=dev)
    gid = torch.searchsorted(starts[1:].contiguous(), slots, right=True)
    in_range = slots < num_rendered
    local = slots - starts[gid]
    rw = rect_w[gid]
    tile = torch.where(in_range, (rect_y0[gid] + local // rw) * tiles_x
                       + rect_x0[gid] + local % rw, num_tiles)
    gid_slot = torch.where(in_range, gid, n)
    depth = depth_bits[gid]
    if upto == "expand":
        return {"tile": tile, "gid": gid_slot, "depth": depth}

    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    dbk = 31 - tile_bits
    key = torch.where(in_range, tile * (1 << dbk) + (depth >> tile_bits),
                      _INT32_MAX)
    sorted_key, perm = torch.sort(key, stable=True)
    sorted_tile = torch.where(sorted_key == _INT32_MAX, num_tiles,
                              sorted_key >> dbk)
    sorted_gid = gid_slot[perm]
    sorted_e = torch.where(in_range, slots, CAPACITY)[perm]
    if upto == "sort":
        return {"tile": sorted_tile, "gid": sorted_gid, "eid": sorted_e}

    tile_ids = torch.arange(num_tiles, device=dev)
    raw_start = torch.searchsorted(sorted_tile, tile_ids, right=False)
    raw_count = torch.searchsorted(sorted_tile, tile_ids,
                                   right=True) - raw_start
    if upto == "ranges":
        return {"start": raw_start, "count": raw_count, "gid": sorted_gid}

    count_eff = torch.clamp_max(raw_count, MAX_PER_TILE)
    seg = (count_eff + ALIGN - 1) // ALIGN * ALIGN
    drop = torch.cumsum(seg, 0) > KCAP
    count_eff = torch.where(drop, 0, count_eff)
    seg = torch.where(drop, 0, seg)
    seg_end = torch.cumsum(seg, 0)
    aligned_start = seg_end - seg
    kslots = torch.arange(KCAP, device=dev)
    owner = torch.searchsorted(aligned_start, kslots, right=True) - 1
    src = kslots + (raw_start - aligned_start)[owner]
    valid = (kslots < seg_end[-1]) & (src < (raw_start + count_eff)[owner])
    if upto == "repack_expand":
        return {"src": src, "valid": valid, "gid": sorted_gid}

    src = torch.clamp(src, 0, CAPACITY - 1)
    return {"gid": torch.where(valid, sorted_gid[src], n).to(torch.int32),
            "eid": torch.where(valid, sorted_e[src],
                               CAPACITY).to(torch.int32),
            "tile_start": aligned_start.to(torch.int32),
            "tile_count": count_eff.to(torch.int32), "valid": valid}


def synthetic_rows(n: int, device):
    """The JAX tool's seeded gradient rows: (cot9 (9, KCAP) float32, eid
    (KCAP,) the kept rank of each slot, ``CAPACITY`` past the kept ones,
    gid (KCAP,) the Gaussian whose run holds that rank, ``n`` past them)."""
    rng = np.random.default_rng(0)
    cot9 = rng.normal(size=(9, KCAP)).astype(np.float32)
    eid = np.full(KCAP, CAPACITY, np.int32)
    eid[:KEPT] = rng.permutation(KEPT).astype(np.int32)
    counts = rng.integers(0, 23, size=n).astype(np.int32)
    counts = (counts * (KEPT / counts.sum())).astype(np.int32)
    gstart = np.concatenate([[0], np.cumsum(counts)[:-1]])
    gid = np.searchsorted(gstart, eid, side="right") - 1
    gid = np.where(eid < counts.sum(), gid, n).astype(np.int32)
    return (torch.from_numpy(cot9).to(device),
            torch.from_numpy(eid).to(device),
            torch.from_numpy(gid).to(device))


def stage_rows(pre, cam) -> list:
    """The "binning upto ..." rows, (name, make_body, carry), at ``cam``'s
    16x16 tiles."""
    tiles = ((cam.width + BLOCK - 1) // BLOCK,
             (cam.height + BLOCK - 1) // BLOCK)

    def make(upto):
        def body(carry, s):
            p, acc = carry
            with torch.no_grad():
                out = binning_stages(p, upto, *tiles, s * 1e-30)
                return p, acc + _micro.sums(*out.values())
        return lambda: body

    z = torch.zeros((), device=pre.depths.device)
    return [(f"binning upto {upto}", make(upto), (pre, z))
            for upto in STAGES]


def reduce_rows(n: int, device) -> list:
    """The gradient-sum rows on the synthetic rows."""
    cot9, eid, gid = synthetic_rows(n, device)

    def sort_only(c, s):
        order = torch.argsort(eid, stable=True)
        return (c[:, order] + s).sum()

    def full(c, s):
        return blend.reduce_by_gaussian(c + s, gid, n).sum()

    def make(fn):
        def body(carry, s):
            c, acc = carry
            with torch.no_grad():
                return c, acc + fn(c, s * 1e-30)
        return lambda: body

    z = torch.zeros((), device=device)
    fns = {"reduce sort-only": sort_only, "reduce full": full}
    return [(name, make(fns[name]) if name in fns else None, (cot9, z))
            for name in REDUCE_ROWS]


def variant_rows(pre) -> list:
    """The expand-stage variants: the four packed per-Gaussian fields
    (id, run start, packed rect, depth bits) expanded to their slots."""
    n = pre.tiles_touched.shape[0]

    def ex_only(p, s):
        tiles_touched = p.tiles_touched.long()
        offsets = torch.cumsum(tiles_touched, 0)
        starts = offsets - tiles_touched
        rect_w = torch.clamp_min(p.rect_max[:, 0] - p.rect_min[:, 0], 1)
        packed_rect = (p.rect_min[:, 0] * (1 << 20)
                       + p.rect_min[:, 1] * (1 << 10) + rect_w)
        fields = torch.stack([
            torch.arange(n, device=starts.device), starts,
            packed_rect.long(),
            (p.depths + s).float().view(torch.int32).long()],
            dim=1).to(torch.int32)
        ex = binning._expand_runs(fields, starts, CAPACITY)
        return (ex[:, 0].sum() + ex[:, 2].sum() + ex[:, 3].sum()
                + offsets[-1])

    def body(carry, s):
        p, acc = carry
        with torch.no_grad():
            return p, acc + ex_only(p, s * 1e-30)

    z = torch.zeros((), device=pre.depths.device)
    return [(name, (lambda: body) if name == "ex only" else None, (pre, z))
            for name in VARIANT_ROWS]


def run(params, state, cam, variants: bool = False) -> dict:
    """Chain and print the binning and gradient-sum rows, or the expand
    variants; returns them with "timing", "launches" and "device"."""
    before = _harness.launch_counts()
    dev = params.xyz.device
    pre = preprocessed(params, state, cam)
    if variants:
        done = _micro.run_rows(variant_rows(pre), NO_COUNTERPART, 12,
                               iters=ITERS, reps=REPS, numbered=False,
                               ms_width=7)
        name = "fdiv checksum match"
        print(_micro.row_line(name + ":", 0, None, NO_COUNTERPART[name]),
              flush=True)
        done.append({"id": len(done), "name": name, "ms": None,
                     "no_counterpart": NO_COUNTERPART[name]})
    else:
        done = _micro.run_rows(stage_rows(pre, cam), NO_COUNTERPART, 27,
                               iters=ITERS, reps=REPS, numbered=False,
                               ms_width=7)
        done += _micro.run_rows(reduce_rows(params.xyz.shape[0], dev),
                                NO_COUNTERPART, 22, iters=ITERS, reps=REPS,
                                numbered=False, ms_width=7)
    for i, row in enumerate(done):
        row["id"] = i
    return _micro.result(done, before, dev)


def main(argv=None) -> dict:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="?", choices=["variants"])
    args = ap.parse_args(argv)
    params, state, cam = demo_scene(n=N, w=W, h=H, sh_degree=3,
                                    device=platform_device())
    return run(params, state, cam, args.variants is not None)


if __name__ == "__main__":
    main()
