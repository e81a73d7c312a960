"""Synthetic inputs of K3 (the tiled z-buffer) and a PyTorch version of
its scatter, shared by the CPU tests and the card tests (no JAX here).

``tile_inputs`` lays instances out as ``zbuffer_pallas.zbuf_inputs`` hands
them to K3: each instance listed in every 32x32 tile its rect touches, each
tile's segment 128-aligned, padding columns holding the zero rect. ``CASES``
are the adversarial tile sets; ``zbuf_tiles_scatter`` takes K3's minimum
over ``depth_key`` keys as the kernel does, from the covered pairs.
"""

import numpy as np
import torch

from neuralgaussiansplatting_torch.ops import zbuffer_pallas as zb

TILE = zb.BX
BIG = np.float32(zb.BIG)


def tile_inputs(rects, gids, depths, tiles_x, tiles_y, seed=None,
                device="cpu"):
    """K3's arguments for instances of pixel rects ``rects`` (N, 4) (x0,
    y0, x1, y1; x1, y1 exclusive), ids ``gids`` (N,) and float32 depths
    ``depths`` (N,) (bits kept as given) on a ``tiles_x`` x ``tiles_y``
    grid. ``seed`` shuffles each tile's instances."""
    rects = np.asarray(rects, np.int64).reshape(-1, 4)
    gids = np.asarray(gids, np.int64)
    depths = np.asarray(depths, np.float32)
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = rects.T
    cols, starts, counts = [], [], []
    offset = 0
    for t in range(tiles_x * tiles_y):
        ox, oy = (t % tiles_x) * TILE, (t // tiles_x) * TILE
        members = np.nonzero((x0 < ox + TILE) & (x1 > ox) & (y0 < oy + TILE)
                             & (y1 > oy) & (x1 > x0) & (y1 > y0))[0]
        if seed is not None:
            members = rng.permutation(members)
        starts.append(offset)
        counts.append(len(members))
        cols.append((offset, members))
        offset += -(-len(members) // zb.CHUNK) * zb.CHUNK
    k = offset + zb.CHUNK        # a padded tail, as binning's capacity
    table = np.zeros((5, k), np.int64)
    table[4] = len(gids)         # padding: the zero rect, gid N
    dep = np.zeros(k, np.float32)
    for start, members in cols:
        sl = slice(start, start + len(members))
        table[:4, sl] = rects[members].T
        table[4, sl] = gids[members]
        dep[sl] = depths[members]
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.tensor(table.astype(np.int32), **i32),
            torch.from_numpy(dep).to(device),
            torch.tensor(starts, **i32), torch.tensor(counts, **i32), tiles_x)


def _footprints(rng, n, w, h, rmax=4):
    cx = rng.uniform(0, w, n)
    cy = rng.uniform(0, h, n)
    r = rng.uniform(0, rmax, n)
    return np.stack([np.maximum(cx - r, 0), np.maximum(cy - r, 0),
                     np.minimum(cx + r + 1, w), np.minimum(cy + r + 1, h)],
                    1).astype(np.int64)


def shuffled_scene(seed=None, device="cpu"):
    """3000 footprint-sized rects on 3x2 tiles, random positive depths
    (some repeated), ids in random order: several staged batches a tile."""
    rng = np.random.default_rng(1)
    n = 3000
    depths = rng.choice(rng.uniform(0.2, 9.0, 400).astype(np.float32), n)
    return tile_inputs(_footprints(rng, n, 96, 64), rng.permutation(n),
                       depths, 3, 2, seed, device)


def equal_depth_stack(seed=None, device="cpu"):
    """600 instances at one depth with ids past 2^25, 200 of them over the
    whole of tile 0, the rest over parts of the 2x1 grid: at every pixel
    the lowest covering id wins."""
    rng = np.random.default_rng(2)
    n = 600
    rects = np.concatenate([np.tile([0, 0, 32, 32], (200, 1)),
                            _footprints(rng, n - 200, 64, 32, rmax=12)])
    gids = (1 << 25) + rng.permutation(4 * n)[:n]
    return tile_inputs(rects, gids, np.full(n, 2.0, np.float32), 2, 1, seed,
                       device)


def edge_depths(seed=None, device="cpu"):
    """-0.0 beside +0.0 (each sign winning the id tie somewhere), NaN, 3e38
    and above (inf), negative depths, -inf, all on one tile."""
    f = np.float32
    nan, inf = f("nan"), f("inf")
    rows = [  # rect, gid, depth
        ([0, 0, 8, 8], 7, f(-0.0)), ([0, 0, 8, 8], 3, f(0.0)),
        ([8, 0, 16, 8], 2, f(-0.0)), ([8, 0, 16, 8], 9, f(0.0)),
        ([16, 0, 24, 8], 4, f(-0.0)),
        ([0, 8, 8, 16], 1, nan),
        ([8, 8, 16, 16], 1, nan), ([8, 8, 16, 16], 5, f(5.0)),
        ([16, 8, 24, 16], 0, BIG), ([16, 8, 24, 16], 6, inf),
        ([24, 8, 32, 16], 0, BIG),
        ([24, 8, 32, 16], 8, np.nextafter(BIG, f(0))),
        ([0, 16, 8, 24], 10, f(1.0)), ([0, 16, 8, 24], 11, f(-4.0)),
        ([8, 16, 16, 24], 12, -inf), ([8, 16, 16, 24], 13, f(-3e38)),
        ([16, 16, 32, 32], 14, f(-1e-45)), ([16, 16, 32, 32], 15, f(1e-45)),
        ([20, 20, 28, 28], 16, f(-0.0)), ([20, 20, 28, 28], 17, nan),
        ([0, 24, 16, 32], 18, f(-0.0)), ([4, 24, 12, 32], 19, f(-0.0)),
    ]
    rects, gids, depths = zip(*rows)
    return tile_inputs(rects, gids, np.array(depths, np.float32), 1, 1, seed,
                       device)


def tile_spanning(seed=None, device="cpu"):
    """Rects over whole tiles and across tile edges of a 3x3 grid,
    negative and past-the-frame coordinates included."""
    rects = [[-10, -10, 70, 70], [16, 16, 48, 48], [31, 0, 33, 96],
             [0, 31, 96, 33], [0, 0, 96, 96], [63, 63, 65, 65],
             [32, 32, 64, 64], [-5, 40, 5, 200], [90, -3, 200, 7]]
    depths = np.array([3.0, 2.0, 1.0, 1.5, 4.0, 0.5, 2.0, 0.7, 0.9],
                      np.float32)
    return tile_inputs(rects, np.arange(len(rects))[::-1], depths, 3, 3, seed,
                       device)


def many_batches(seed=None, device="cpu"):
    """2000 instances on one tile: many 256-instance steps and 128-column
    chunks, the last one partial."""
    rng = np.random.default_rng(4)
    n = 2000
    return tile_inputs(_footprints(rng, n, 32, 32, rmax=6),
                       rng.permutation(n),
                       rng.uniform(0.2, 50.0, n).astype(np.float32), 1, 1,
                       seed, device)


def empty_tiles(seed=None, device="cpu"):
    """A 4x3 grid where only three tiles hold instances."""
    rects = [[3, 3, 9, 9], [70, 40, 75, 50], [100, 90, 128, 96]]
    return tile_inputs(rects, [0, 1, 2], np.ones(3, np.float32), 4, 3, seed,
                       device)


def shuffle_tiles(args, seed=0):
    """K3's arguments with each tile's instances in a random order."""
    rects, depth, tile_start, tile_count, tiles_x = args
    rng = np.random.default_rng(seed)
    perm = np.arange(rects.shape[1])
    for start, count in zip(tile_start.tolist(), tile_count.tolist()):
        perm[start:start + count] = rng.permutation(perm[start:start + count])
    perm = torch.from_numpy(perm).to(rects.device)
    return (rects[:, perm].contiguous(), depth[perm].contiguous(), tile_start,
            tile_count, tiles_x)


CASES = {"shuffled_scene": shuffled_scene, "equal_depth_stack":
         equal_depth_stack, "edge_depths": edge_depths,
         "tile_spanning": tile_spanning, "many_batches": many_batches,
         "empty_tiles": empty_tiles}


def zbuf_tiles_scatter(rects, depth, tile_start, tile_count, tiles_x):
    """K3's algorithm in PyTorch: every covered (instance, pixel) pair of a
    tile, the instance's rect clipped to the tile, keyed (depth_key(depth)
    above gid ^ 2^31), the per-pixel minimum key, decoded; a winner whose
    own depth is -0.0 writes -0.0. NaN and depths at or above BIG take no
    pair."""
    count = tile_count.long()
    num_tiles = count.shape[0]
    n = int(count.sum())
    tile = torch.repeat_interleave(torch.arange(num_tiles), count)
    first = torch.cumsum(count, 0) - count
    col = (torch.repeat_interleave(tile_start.long(), count)
           + torch.arange(n) - torch.repeat_interleave(first, count))
    d = depth[col]
    x0, y0, x1, y1, g = rects[:, col].long()
    ox = (tile % tiles_x) * TILE
    oy = (tile // tiles_x) * TILE
    cx0 = (x0 - ox).clamp(0, TILE)
    cy0 = (y0 - oy).clamp(0, TILE)
    w = ((x1 - ox).clamp(max=TILE) - cx0).clamp_min(0)
    h = ((y1 - oy).clamp(max=TILE) - cy0).clamp_min(0)
    area = torch.where(d < BIG, w * h, 0)           # False for NaN
    key = ((zb.depth_key(d) - (1 << 31)) << 32) + (g + (1 << 31))
    pair = torch.repeat_interleave(torch.arange(n), area)
    r = torch.arange(pair.shape[0]) - torch.repeat_interleave(
        torch.cumsum(area, 0) - area, area)
    pix = (tile[pair] * zb.PIX + (cy0[pair] + r // w[pair]) * TILE
           + cx0[pair] + r % w[pair])
    miss = torch.iinfo(torch.int64).max
    best = torch.full((num_tiles * zb.PIX,), miss, dtype=torch.int64)
    best.scatter_reduce_(0, pix, key[pair], "amin")
    hit = best != miss
    gid = torch.where(hit, (best & 0xFFFFFFFF) - (1 << 31), -1)
    out = torch.where(hit, zb.key_depth((best >> 32) + (1 << 31)), 0.0)
    neg_zero = (d[pair].view(torch.int32) == -(1 << 31)) \
        & (key[pair] == best[pix])
    out[pix[neg_zero]] = -0.0
    return (gid.to(torch.int32).reshape(num_tiles, zb.PIX),
            out.reshape(num_tiles, zb.PIX))
