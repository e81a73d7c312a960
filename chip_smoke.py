"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from csrc/ (K1, the 32x32 tile blend;
K2, its backward; K3, the neural path's z-buffer; K4, the blend at any tile
shape, 16x16 on the pallas path; K5, its backward; K6, the run-length
decode; K7, the idiom probes), holds each against its plain PyTorch version
at the shapes of its workload, then drives the paths as a user would.

Classic path (800x800, 100k Gaussians, SH degree 3, the bench rasterizer
settings): a demo cloud saved to PLY, loaded back and rendered from four
cameras through ``gaussian_renderer.render``; 20 training steps through
``train.loop.train_step``; 30 iterations of ``train.loop.Trainer`` with
densification.

Pallas path (the same cloud, ``make_settings("pallas")``: 16x16 tiles,
capacities from a probe render): four renders, a 16x16 "seq" setting routed
to K4, K4 and K5 against their plain versions at 16x16 and at 32x32 tiles,
10 ``train_step``s; then the garden regime of ``tools/bench_garden.py
--scatter`` (1920x1080, 5M Gaussians): forward and fwd+bwd times, finite
gradients, the image against the 32x32 seq render of the same cloud, K4 and
K5 against their plain versions there with their device times and bounds;
and the seq path at those shapes: K1 and K2 against their plain versions,
their device times and bounds, seq render and fwd+bwd times.

Scene path (the port's user path from files on disk): the port's
``tools.make_demo_scene`` writes an 800x800 Blender scene (24 train and 6
test views, 120k GT Gaussians, a 100k-point init cloud);
``python -m neuralgaussiansplatting_torch.train``'s ``main`` trains it 600
iterations (K1 and K2 once per iteration, test PSNR up by 2 dB, no drops);
a subprocess resumes from the iteration-300 checkpoint; a COLMAP-layout
copy trains 100 iterations at -r 2.

Neural path (800x800, 100k Gaussians, SH degree 1, seeded 64-d features,
full-width decoders): the tiled z-buffer against the per-pixel sort oracle;
a 64x64 card-vs-CPU reference; ``render1/2/3`` from four cameras; 10 steps
of ``train.neural_loop.NeuralTrainer(sw=2)``.

Tools: K6 against its plain version and ``binning._expand_runs`` at the
decode tool's two workloads (100k runs over 655,360 slots; 5M over
8,388,608) and on an edge case, K7's ten probes against theirs; then the
port's ``tools.exp_decode_proto`` and ``tools.exp_mosaic_probe`` mains and
every ``tools.chain_bench`` configuration once.

Each path checks that it went through its kernels. It prints one JSON line
of per-kernel numbers, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line. Needs a CUDA device and nvcc (CUDA_HOME or
/usr/local/cuda); imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import struct
import tempfile
import time

import numpy as np
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch import native
from neuralgaussiansplatting_torch import gaussian_renderer as gr
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.models import nets
from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import blend_pallas
from neuralgaussiansplatting_torch.ops import blend_seq
from neuralgaussiansplatting_torch.ops import decode_runs
from neuralgaussiansplatting_torch.ops import idxmap as idxmap_ops
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import blend as blend_plain
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops import zbuffer_pallas
from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.scene import colmap as colmap_io
from neuralgaussiansplatting_torch.scene import image_io
from neuralgaussiansplatting_torch.scene import ply as ply_io
from neuralgaussiansplatting_torch.tools import chain_bench
from neuralgaussiansplatting_torch.tools import exp_decode_proto
from neuralgaussiansplatting_torch.tools import exp_mosaic_probe
from neuralgaussiansplatting_torch.tools import make_demo_scene
from neuralgaussiansplatting_torch.train import __main__ as train_entry
from neuralgaussiansplatting_torch.train import loop
from neuralgaussiansplatting_torch.train import neural_loop
from neuralgaussiansplatting_torch.train import optim
from neuralgaussiansplatting_torch.utils import losses
from neuralgaussiansplatting_torch.utils.timing import cuda_ms, device_ms

W = H = 800
N = 100_000
SH_DEGREE = 3
SETTINGS = rast.make_settings(
    "seq", capacity=512 * 1024, packed_capacity=512 * 1024,
    max_per_tile=4096, fast_sort=True, tight_culling=True, precise_cull=True)
VIEWS = (0.0, 0.5 * math.pi, math.pi, 1.5 * math.pi)   # about the y axis
# H100 SXM data sheet peaks (dense, no sparsity), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations counted as the function needs them, expf (logf, sqrtf) as
# one; the comparisons and selects are not counted. The four blend kernels
# (K1 and K4 forward, K2 and K5 backward) need, of the (instance, pixel)
# pairs that a pixel must consider (forward: those it visits while not done;
# backward: those before its own n_contrib), the power only where the pixel
# lies inside the instance's box and alpha only where the power lies in
# [cutoff, 0] (the kernels' own cutoff and box, which leave out only pairs
# whose alpha is 0; ``blend_seq.blend_pair_counts`` counts them). The power
# by what each of its terms depends on, (per such pair, per (instance,
# pixel column) and per (instance, pixel row) of a tile that holds one):
# "seq" (K1, K2), -0.5*(A*(dx*dx) + C*(dy*dy)) - B*(dx*dy): dx, dx*dx,
# A*(dx*dx) per column (3), the same in dy per row (3), dx*dy, B*(dx*dy),
# the add, *-0.5 and the sub per pair (5); "pallas" (K4, K5),
# -0.5*((A*dx)*dx + (C*dy)*dy) - (B*dx)*dy: dx, A*dx, (A*dx)*dx, B*dx per
# column (4), dy, C*dy, (C*dy)*dy per row (3), the add, *-0.5, (B*dx)*dy
# and the sub per pair (4).
POWER_OPS = {"seq": (5, 3, 3), "pallas": (4, 4, 3)}
# alpha: expf, 1 mul + 1 min.
ALPHA_OPS = 3
# Per instance of a tile up to the last one that a pixel needs: the cutoff
# (div, logf, abs, add, mul, sub) and the box (A*C, det 2, B^2 and 0.998 AC
# 2, r^2 2, two half-widths of 5, 4 edges).
STAGE_OPS = 6 + 21
# K1, per blended pair on top: 1 mul + 1 sub (T), 3 mul + 3 add (color).
K1_BLEND_OPS_PER_PAIR = 8
# K2, per blended pair on top: 3 mul + 2 add (cdot), 1 mul + 1 sub (T),
# 1 mul + 1 add (prefix); 5 (dalpha: T*cdot, tot - prefix, 1 - a, div, sub),
# 1 mul (dpow), 6 + 6 (d mean2d x, y: neg, 2 mul, sub, mul, add), 4 + 4 + 4
# (d conic A, B, C: neg or mul, 2 mul, add), 2 (d opacity: mul, add), 3 x 2
# (d rgb: mul, add); the warp and block sums are those adds.
K2_BLEND_OPS_PER_PAIR = 9 + 38
JAX_GATE = (5e-4, 5e-3)  # gradient atol (x max |row|), rtol: the JAX seq gate
# K2 vs its plain version on one card: only the order of the pixel sums
# differs (readings 1.4e-7 and 3.0e-7 of a row's scale), so max |d| must stay
# within this share of each row's scale as well as inside the JAX gate
SAME_CARD_REL = 1e-5
TRAIN_STEPS = 20
TRAINER_ITERS = 30
# The neural path: tools/bench_suite.py's neural configuration (800x800,
# the demo cloud of 100k Gaussians at SH degree 1, render2, z-buffer
# capacity 2^19 tile instances), with seeded 64-d features.
NEURAL_SH = 1
TILE_CAPACITY = 1 << 19     # z-buffer tile instances
ORACLE_CAPACITY = 1 << 21   # the per-pixel sort oracle's pixel instances
NEURAL_STEPS = 10
# K3, per (instance, pixel) pair where the instance's rect covers the pixel
# (what a per-pixel argmin over rects needs, and what the kernel walks):
# 3 compares, 1 and, 1 or (nearer, or as near with a lower id), 2 selects.
# These are 32-bit integer and float compare/logic/select operations; the
# data sheet lists no INT32 rate, so the bound takes its FP32 rate, which
# no 32-bit ALU operation beats: the bound stays a lower limit.
K3_OPS_PER_PAIR = 7
# The pallas path at the bench width: make_settings("pallas") (16x16 tiles,
# chunk 128) with the bench flags; capacity and packed_capacity are sized
# from a probe render of each phase's cloud, as tools/bench_garden.py sizes
# them.
PALLAS_PROBE = rast.make_settings(
    "pallas", capacity=1 << 21, max_per_tile=4096, fast_sort=True,
    tight_culling=True, precise_cull=True)
PALLAS_STEPS = 10
# K4 and K5 are also held and timed at 32x32 tiles (what a seq setting of
# another chunk routes to them): make_settings("pallas", block_x=32,
# block_y=32) with the same flags, sized the same way.
PALLAS_PROBE_32 = dataclasses.replace(PALLAS_PROBE, block_x=32, block_y=32)
# K4, per blended pair on top: 1 sub + 1 mul (T_i = T_{i-1} * (1 - a)),
# 1 mul (w = a * T_{i-1}), 3 mul + 3 add (color).
K4_BLEND_OPS_PER_PAIR = 9
# K5, per blended pair on top: 1 sub + 1 mul (T), 1 mul (w), 3 mul + 2 add
# (cdot), 1 mul + 1 add (prefix), 1 sub (suffix), 4 (dalpha: T * cdot,
# suffix + tfin_gt, div, sub), 2 mul (dpow = g * (op * dalpha)), 6 + 6
# (d mean2d x, y: neg, 2 mul, sub, mul, add), 4 + 4 + 4 (d conic A, B, C:
# neg or mul, mul, mul, add), 2 (d opacity: mul, add), 3 x 2 (d rgb: mul,
# add); the warp and block sums are those adds.
K5_BLEND_OPS_PER_PAIR = 49
# The garden regime of tools/bench_garden.py --scatter: the demo cloud of
# GARDEN_N points (seed 3, SH3) with its log-scales lowered by 2.2, at
# 1920x1080, on the pallas path at 16x16 tiles and chunk 128 with
# max_per_tile 4096, fast_sort, tight_culling and precise_cull; capacities
# from a probe render. The seq cross-check renders the same cloud at 32x32
# with max_per_tile 8192.
GARDEN_N = 5_000_000
GARDEN_W, GARDEN_H = 1920, 1080
GARDEN_PROBE = rast.make_settings(
    "pallas", capacity=1 << 25, max_per_tile=4096, fast_sort=True,
    tight_culling=True, precise_cull=True)
# 16x16 and 32x32 tilings differ by design in the 3..3.33-sigma band of each
# splat's rect (tests/test_blend_seq.py:58-75): max and mean |d| limits
BAND_GATE = (0.05, 1e-3)
# The scene phase: the port's demo-scene tool writes an 800x800 Blender
# scene (24 train views, 6 test views, the video orbit) from 120k GT
# Gaussians with a 100k-point init cloud, and the port's train entry point
# trains it as a user would, at train.py's defaults (seq backend, 32x32 /
# chunk 128) but for the short schedule below; then a resume from the
# halfway checkpoint in a subprocess and a COLMAP-layout copy at -r 2.
SCENE_TOOL_ARGS = ["--size", "800", "--views", "24", "--n_gaussians",
                   "120000", "--init_points", "100000"]
SCENE_ITERS, SCENE_CHECKPOINT, COLMAP_ITERS = 600, 300, 100
SCENE_TRAIN_ARGS = ["--eval", "--densify_from_iter", "100",
                    "--densification_interval", "100", "--tune_interval",
                    "100", "--disable_viewer"]
MIRROR_Z = np.array([1.0, 1.0, -1.0])
SCENE_PSNR_GAIN = 2.0    # dB, test views, iteration SCENE_ITERS over 1
# the root train.py's files, as tests/test_cli.py:41-47 lists them
SCENE_FILES = (f"point_cloud/iteration_{SCENE_ITERS}/point_cloud.ply",
               f"chkpnt{SCENE_CHECKPOINT}.ckpt", "cfg_args", "cfg_args.json",
               "cameras.json", "input.ply")
# K6 at the decode tool's workloads (tools/exp_decode_proto.py:160-162), f =
# 6 columns. Its bound counts the bytes the function must move: each run's
# start and f diffs read once (runs that start inside the domain), f int32
# words written per slot; its operations, one integer add per run and
# column and one per slot and column, at the FP32 rate (no INT32 rate is
# listed), are ~100x below that.
K6_WORKLOADS = exp_decode_proto.WORKLOADS
K6_F = exp_decode_proto.F
# exp_decode_proto.main launches K6 once per workload to check it and
# (reps + 1) * (iters + 1) times in its chain
K6_TOOL_LAUNCHES = len(K6_WORKLOADS) * (
    1 + (exp_decode_proto.REPS + 1) * (exp_decode_proto.ITERS + 1))
# K6's wrapper host cost is timed part by part at the 800p workload (host
# clock over HOST_REPS calls, median of HOST_ROUNDS), and K6 is chained
# against repeat_interleave there in CHAIN_TURNS alternating turns of
# CHAIN_ITERS steps (best of CHAIN_REPS), longer than the decode tool's
# chain of 4 steps, best of 2.
HOST_REPS, HOST_ROUNDS = 200, 7
CHAIN_TURNS, CHAIN_ITERS, CHAIN_REPS = 3, 20, 5
# K7's p6_transpose against x.t().contiguous(): device time per launch in
# this many alternating turns of 50 launches each
K7_TURNS = 5
# K7: each probe reads x (16, 128) float32 once and writes its output once;
# its few float adds are nothing beside that.
K7_PROBES = exp_mosaic_probe.PROBES
# the blend and z-buffer kernels each configuration of tools.chain_bench
# launches once per step
CHAIN_KERNELS = {"classic_fb": ("K4", "K5"), "classic_fb_seq": ("K1", "K2"),
                 "classic_fwd_seq": ("K1",), "classic_fwd1080_seq": ("K1",),
                 "classic_fwd1080": ("K4",), "neural_fb": ("K3",),
                 "neural_fb_bf16": ("K3",)}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def k1_inputs(params, state, cam, mark=lambda stage: None,
              settings=SETTINGS):
    """Preprocess -> bin -> pack as ``rasterize`` runs them for one view:
    the inputs the blend kernel of ``settings`` sees on the main path (K1's
    for the seq settings, K4's for the pallas ones). ``mark(stage)`` is
    called after each stage."""
    tiles_x, tiles_y = settings.tiles_for(cam.width, cam.height)
    pre = pp.preprocess_gaussians(
        params.xyz, gm.get_scaling(params), gm.get_rotation(params),
        gm.get_opacity(params, state.alive), gm.get_features(params),
        SH_DEGREE, cam, settings.block_x, settings.block_y,
        tight=settings.tight_culling)
    mark("preprocess")
    inst = binning.bin_gaussians(
        pre, tiles_x, tiles_y, settings.capacity, settings.max_per_tile,
        settings.chunk, pack_keys=settings.fast_sort,
        packed_capacity=settings.packed_capacity,
        precise_cull=settings.precise_cull, block_x=settings.block_x,
        block_y=settings.block_y, width=cam.width, height=cam.height)
    mark("bin")
    packed = blend_pallas.pack_gather(blend_pallas.pack_instance_attrs_t(
        pre.means2d, pre.conic, pre.opacity, pre.rgb), inst.gid)
    mark("pack")
    return packed, inst, tiles_x


def launch_counts() -> dict:
    return {"K1": blend_seq.launches, "K2": blend_seq.bwd_launches,
            "K4": blend_pallas.launches, "K5": blend_pallas.bwd_launches}


def reset_launch_counts():
    blend_seq.launches = blend_seq.bwd_launches = 0
    blend_pallas.launches = blend_pallas.bwd_launches = 0
    zbuffer_pallas.launches = 0
    decode_runs.launches = exp_mosaic_probe.launches = 0


def sized_settings(probe, params, alive, cam):
    """``probe`` with capacity the next power of two above 1.15 x
    num_rendered and packed_capacity aligned_demand x 1.05 rounded up to a
    multiple of 2^17, read from one render with ``probe``
    (tools/bench_garden.py's sizing). Returns (settings, probe's output)."""
    with torch.no_grad():
        out = render(cam, params, alive, SH_DEGREE,
                     torch.zeros(3, device="cuda"), probe)
    check(int(out["dropped"]) == 0,
          f"the probe render dropped {int(out['dropped'])} instances")
    num_rendered = int(out["num_rendered"])
    demand = int(out["aligned_demand"])
    cap = 1 << max(int(num_rendered * 1.15).bit_length(), 1)
    kcap = (int(demand * 1.05) // (1 << 17) + 1) * (1 << 17)
    return dataclasses.replace(probe, capacity=cap,
                               packed_capacity=kcap), out


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build(["blend_seq_fwd", "blend_seq_bwd", "blend_seq_stage",
                         "zbuffer_fwd", "blend_pallas_fwd",
                         "blend_pallas_bwd", "decode_runs", "mosaic_probe"])
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")


def kernel_row(name, source, replaces, err, ms, dispatch_ms, plain_ms,
               t_bytes, t_ops, library_ms=None):
    """A kernel's entry of the kernels line; ``replaces`` is the TPU
    kernel's path:line from the repo root, ``ms`` device time per launch
    (``device_ms``), ``dispatch_ms`` per back-to-back launch (``cuda_ms``)
    (``launches`` is filled in by the main path's run)."""
    return {"name": name, "route": "cuda",
            "source": f"neuralgaussiansplatting_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "dispatch_ms": dispatch_ms}


def pair_ops(kernel, blend_ops, tile, association):
    """The operation count of a blend kernel as the function needs it
    (``blend_seq.blend_pair_counts`` at ``tile`` (block_x, block_y), the
    power rounded in ``association``): forward ("k1", "k4") or backward
    ("k2", "k5"), ``blend_ops`` per blended pair; a ``count`` for
    ``fwd_parity`` and ``bwd_parity``. Fails unless the blended pairs, and
    the forward's visited pairs, are the plain version's."""
    side = "fwd" if kernel in ("k1", "k4") else "bwd"

    def count(args, raw, pairs, blended):
        n = blend_seq.blend_pair_counts(*args[:4], *tile, raw, association)
        check(n["blended"] == blended and (side == "bwd"
                                           or n["visited"] == pairs),
              f"{kernel} pair counts {n} disagree with the plain version's "
              f"({pairs} visited or walked, {blended} blended)")
        per_pair, per_col, per_row = POWER_OPS[association]
        ops = (per_pair * n[f"{side}_box"] + per_col * n[f"{side}_cols"]
               + per_row * n[f"{side}_rows"]
               + ALPHA_OPS * n[f"{side}_live"]
               + STAGE_OPS * n[f"{side}_staged"] + blend_ops * blended)
        walk = ("visited" if side == "fwd"
                else f"walked to each pixel's n_contrib, {n['walked']} of "
                     f"{pairs} walked to the tile's stop")
        return ops, (f"pairs needing the power {n[f'{side}_box']} (in "
                     f"{n[f'{side}_cols']} instance columns, "
                     f"{n[f'{side}_rows']} rows), alpha "
                     f"{n[f'{side}_live']}, blended {blended} (of "
                     f"{n['visited'] if side == 'fwd' else n['walked']} "
                     f"{walk}); staged instances {n[f'{side}_staged']}")
    return count


def fwd_parity(label, kernel, plain, args, pix, count_ops, plain_reps=2):
    """A blend forward kernel (K1, K4) vs its plain version on the card, bit
    for bit (color, T and n_contrib): ``args`` are both's arguments, the
    first three (packed, tile_start, tile_count). The plain version's time
    is the mean of ``plain_reps``
    calls (CUDA events), or with 0 that of the parity run (host clock).
    ``count_ops(args, output, visited, blended)`` gives the bound's FP32
    operations and their account. Returns (max |d| of color and T, device
    ms, dispatch ms, plain ms, bound by bytes, bound by operations)."""
    packed, _, tile_count = args[:3]
    got = kernel(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, pairs, blended = plain(*args, return_pairs=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (got[:, :4] - want[:, :4]).abs().max().item()
    agree = (got[:, 4] == want[:, 4]).float().mean().item()
    n_inst = int(tile_count.sum())
    num_tiles = tile_count.shape[0]
    print(f"{label} parity: tiles {num_tiles}, K {packed.shape[1]}, "
          f"instances {n_inst}, max|d| color/T {err:.3e}, n_contrib agree "
          f"{agree:.6f} (gate: bit-equal)")
    check(torch.isfinite(got).all().item(), f"{label.upper()} output not "
          "finite")
    check(torch.equal(got, want), f"{label.upper()} is not bit-equal to its "
          f"plain version: max|d| {err}, n_contrib agree {agree}")

    ms = device_ms(lambda: kernel(*args), reps=50)
    dispatch_ms = cuda_ms(lambda: kernel(*args), reps=50)
    if plain_reps:
        plain_ms = cuda_ms(lambda: plain(*args), reps=plain_reps)
    ops, account = count_ops(args, got, pairs, blended)
    nbytes = (blend_pallas.PROWS * n_inst * 4 + 2 * num_tiles * 4
              + num_tiles * 5 * pix * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    print(f"{label} timing: {ms:.4f} ms/launch (device time, 50 launches), "
          f"{dispatch_ms:.4f} ms/launch (CUDA events, 50 back to back), "
          f"plain version {plain_ms:.1f} ms; {account}, {ops:.4g} FP32 ops "
          f"-> {t_ops:.4f} ms; {nbytes} bytes -> {t_bytes:.4f} ms")
    return err, ms, dispatch_ms, plain_ms, t_bytes, t_ops


def phase_k1_parity(params, state):
    """K1 vs its plain version on the card, at the bench shapes."""
    packed, inst, tiles_x = k1_inputs(params, state, demo.demo_camera(W, H))
    args = (packed, inst.tile_start, inst.tile_count, tiles_x)
    return kernel_row(
        "blend_seq_fwd", "blend_seq_fwd.cu",
        "neuralgaussiansplatting_tpu/ops/blend_seq.py:91",
        *fwd_parity("k1", blend_seq.blend_seq_fwd,
                    blend_seq.blend_tiles_seq_reference, args,
                    blend_seq.PIX, pair_ops("k1", K1_BLEND_OPS_PER_PAIR,
                                            (blend_seq.BX, blend_seq.BY),
                                            "seq")))


def parity_entry(numbers, tile_count):
    """A kernel's numbers at another workload (``fwd_parity``'s or
    ``bwd_parity``'s) as an entry of its row."""
    err, ms, dispatch_ms, plain_ms, t_bytes, t_ops = numbers
    return {"instances": int(tile_count.sum()), "tiles": tile_count.numel(),
            "max_abs_err": err, "ms": ms, "dispatch_ms": dispatch_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k4_numbers(label, packed, inst, tiles_x, tile, plain_reps=2):
    """``fwd_parity`` of K4 at tiles of ``tile`` (block_x, block_y)."""
    args = (packed, inst.tile_start, inst.tile_count, tiles_x, *tile)
    return fwd_parity(label, blend_pallas.blend_pallas_fwd,
                      blend_pallas.blend_tiles_pallas_reference, args,
                      tile[0] * tile[1],
                      pair_ops("k4", K4_BLEND_OPS_PER_PAIR, tile, "pallas"),
                      plain_reps=plain_reps)


def k5_numbers(label, packed, inst, tiles_x, tile, size=(W, H),
               plain_reps=1):
    """``bwd_parity`` of K5 at tiles of ``tile`` (block_x, block_y)."""
    return bwd_parity(label, blend_pallas.blend_pallas_fwd,
                      blend_pallas.blend_pallas_bwd,
                      blend_pallas.blend_tiles_pallas_bwd_reference, packed,
                      inst, (tiles_x, *tile), tile,
                      pair_ops("k5", K5_BLEND_OPS_PER_PAIR, tile, "pallas"),
                      size=size, plain_reps=plain_reps)


def kernel_layout(label, name, tile):
    """Print and return the launch that K4 or K5 (``name``) takes at
    ``tile`` (block_x, block_y) and its residency on this card, as the CUDA
    runtime reports them (``blend_pallas.kernel_layout``)."""
    lay = blend_pallas.kernel_layout(name, *tile)
    print(f"{label} launch at {tile[0]}x{tile[1]}: {lay['threads']} threads "
          f"x {lay['ctas_per_tile']} CTAs per tile, {lay['registers']} "
          f"registers per thread, {lay['static_smem']} + "
          f"{lay['dynamic_smem']} bytes of shared memory per CTA, "
          f"{lay['ctas_per_sm']} resident CTAs per SM")
    return lay


def phase_k4_k5_parity(params, state, settings, settings_32):
    """K4 and K5 vs their plain versions on the card, at the bench shapes
    with the pallas settings (16x16) and with 32x32 tiles (each row's
    ``"tile_32"``; the plain versions timed by their one parity run), with
    each launch's layout and residency (``"layout"``). Returns the two
    rows."""
    rows = {}
    for tiles in (settings, settings_32):
        tile = (tiles.block_x, tiles.block_y)
        layouts = {"K4": kernel_layout("k4", "blend_pallas_fwd", tile),
                   "K5": kernel_layout("k5", "blend_pallas_bwd", tile)}
        packed, inst, tiles_x = k1_inputs(params, state,
                                          demo.demo_camera(W, H),
                                          settings=tiles)
        tile_load(f"pallas 800x800 {tile[0]}x{tile[1]}", inst.tile_count,
                  blend_pallas.blend_pallas_fwd(
                      packed, inst.tile_start, inst.tile_count, tiles_x,
                      *tile))
        if tiles is settings:
            rows["K4"] = kernel_row(
                "blend_pallas_fwd", "blend_pallas_fwd.cu",
                "neuralgaussiansplatting_tpu/ops/blend_pallas.py:260",
                *k4_numbers("k4", packed, inst, tiles_x, tile))
            rows["K5"] = kernel_row(
                "blend_pallas_bwd", "blend_pallas_bwd.cu",
                "neuralgaussiansplatting_tpu/ops/blend_pallas.py:353",
                *k5_numbers("k5", packed, inst, tiles_x, tile))
        else:
            rows["K4"]["tile_32"] = parity_entry(k4_numbers(
                "k4 32x32", packed, inst, tiles_x, tile, plain_reps=0),
                inst.tile_count)
            rows["K5"]["tile_32"] = parity_entry(k5_numbers(
                "k5 32x32", packed, inst, tiles_x, tile, plain_reps=0),
                inst.tile_count)
        for name in ("K4", "K5"):
            entry = rows[name] if tiles is settings else rows[name]["tile_32"]
            entry["layout"] = layouts[name]
    return rows


def gate_error(got, want, same_card=False):
    """Largest |got - want| / max|want row| over the rows of (R, ...)
    tensors; fails where the JAX gradient gate does, and with
    ``same_card`` where an error passes ``SAME_CARD_REL`` of its row's
    scale."""
    atol, rtol = JAX_GATE
    worst = 0.0
    for row in range(want.shape[0]):
        scale = want[row].abs().max().item() + 1e-12
        err = (got[row] - want[row]).abs()
        check(bool((err <= atol * scale + rtol * want[row].abs()).all()),
              f"row {row} outside the JAX gradient gate: max |d| "
              f"{err.max().item():.3e}, row scale {scale:.3e}")
        check(not same_card or err.max().item() <= SAME_CARD_REL * scale,
              f"row {row}: max |d| {err.max().item():.3e} passes "
              f"{SAME_CARD_REL} of the row scale {scale:.3e}")
        worst = max(worst, err.max().item() / scale)
    return worst


def photometric_cotangent(raw, tiles_x, tiles_y, target, bg, block_x=32,
                          block_y=32):
    """d photometric_loss / d raw, with the image (of ``target``'s size)
    assembled from a blend kernel's output (K1's, or K4's at its tile size)
    as ``rasterize`` assembles it."""
    raw = raw.detach().requires_grad_()
    color = raw[:, 0:3].transpose(1, 2) + raw[:, 3][..., None] * bg
    image = blend_plain.assemble_image(
        color, tiles_x, tiles_y, block_x, block_y, target.shape[2],
        target.shape[1]).permute(2, 0, 1)
    loss = losses.photometric_loss(image, target, 0.2)
    return torch.autograd.grad(loss, raw)[0].contiguous()


def bwd_parity(label, fwd, bwd, plain, packed, inst, rest, tile, count_ops,
               size=(W, H), plain_reps=1):
    """A blend backward kernel (K2, K5) vs its plain version on the card,
    with the cotangent of the photometric loss against a seeded target of
    ``size`` (width, height): ``fwd``/``bwd``/``plain`` take (packed,
    tile_start, tile_count[, raw, cot], *rest); ``tile`` is (block_x,
    block_y); ``plain_reps`` and ``count_ops`` (with the walked pairs) as in
    ``fwd_parity``. Returns (max |d|, device ms, dispatch ms, plain ms,
    bound by bytes, bound by operations)."""
    args = (packed, inst.tile_start, inst.tile_count)
    raw = fwd(*args, *rest)
    gen = torch.Generator(device="cuda").manual_seed(7)
    target = torch.rand((3, size[1], size[0]), generator=gen, device="cuda")
    tiles_x = rest[0]
    cot = photometric_cotangent(raw, tiles_x, inst.tile_count.shape[0]
                                // tiles_x, target,
                                torch.zeros(3, device="cuda"), *tile)
    bwd_args = (*args, raw, cot, *rest)
    got = bwd(*bwd_args)
    again = bwd(*bwd_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, walked, blended = plain(*bwd_args, return_pairs=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.isfinite(got).all().item(), f"{label.upper()} output not "
          "finite")
    check(torch.equal(got, again), f"two {label.upper()} launches differ")
    worst = gate_error(got, want, same_card=True)
    err = (got - want).abs().max().item()
    stop = torch.minimum(inst.tile_count,
                         raw[:, 4].amax(dim=1).to(torch.int32))
    # how much of each row the JAX gate's atol alone would let through
    present = want.abs().amax(dim=0) > 0
    quiet = [(want[row, present].abs()
              < JAX_GATE[0] * want[row].abs().max()).float().mean().item()
             for row in range(want.shape[0])]
    print(f"{label} parity: cotangent of L1+SSIM vs a seeded target, max|d| "
          f"{err:.3e}, max|d| / row scale {worst:.3e} (gates: "
          f"{SAME_CARD_REL} x row scale on one card; JAX atol "
          f"{JAX_GATE[0]} x row scale, rtol {JAX_GATE[1]}), two launches "
          f"bit-equal; walked {int(stop.sum())} of "
          f"{int(inst.tile_count.sum())} instances")
    print(f"{label} parity: share of each row's nonzero slots below the JAX "
          "atol: " + ", ".join(f"{q:.4f}" for q in quiet))

    ms = device_ms(lambda: bwd(*bwd_args), reps=50)
    dispatch_ms = cuda_ms(lambda: bwd(*bwd_args), reps=50)
    if plain_reps:
        plain_ms = cuda_ms(lambda: plain(*bwd_args), reps=plain_reps)
    ops, account = count_ops((*args, *rest), raw, walked, blended)
    num_tiles = inst.tile_count.shape[0]
    nbytes = (blend_pallas.PROWS * int(stop.sum()) * 4 + 2 * num_tiles * 4
              + num_tiles * (5 + 4) * tile[0] * tile[1] * 4
              + blend_pallas.PROWS * packed.shape[1] * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    print(f"{label} timing: {ms:.4f} ms/launch (device time, 50 launches), "
          f"{dispatch_ms:.4f} ms/launch (CUDA events, 50 back to back), "
          f"plain version {plain_ms:.1f} ms; {account}, {ops:.4g} FP32 ops "
          f"-> {t_ops:.4f} ms; {nbytes} bytes -> {t_bytes:.4f} ms")
    return err, ms, dispatch_ms, plain_ms, t_bytes, t_ops


def tile_load(label, tile_count, raw):
    """Print the mean, p99 and max of the tiles' instance counts and of
    their stops (the deepest contributor, where K2's walk ends)."""
    stop = torch.minimum(tile_count, raw[:, 4].amax(dim=1).to(torch.int32))

    def stats(x):
        x = x.double()
        return (f"mean {x.mean().item():.1f}, p99 "
                f"{torch.quantile(x, 0.99).item():.1f}, max "
                f"{int(x.max())}")

    print(f"{label} tile load: {tile_count.numel()} tiles; tile_count "
          f"{stats(tile_count)}; stop {stats(stop)}")


def phase_k2_parity(params, state):
    """K2 vs its plain version on the card, at the bench shapes."""
    packed, inst, tiles_x = k1_inputs(params, state, demo.demo_camera(W, H))
    tile_load("bench 800x800", inst.tile_count, blend_seq.blend_seq_fwd(
        packed, inst.tile_start, inst.tile_count, tiles_x))
    return kernel_row(
        "blend_seq_bwd", "blend_seq_bwd.cu",
        "neuralgaussiansplatting_tpu/ops/blend_seq.py:202",
        *bwd_parity("k2", blend_seq.blend_seq_fwd, blend_seq.blend_seq_bwd,
                    blend_seq.blend_tiles_seq_bwd_reference, packed, inst,
                    (tiles_x,), (blend_seq.BX, blend_seq.BY),
                    pair_ops("k2", K2_BLEND_OPS_PER_PAIR,
                             (blend_seq.BX, blend_seq.BY), "seq")))


def phase_small_reference():
    """The path on the card vs the plain scan oracle on the CPU, at 64x64:
    preprocess and binning on the GPU, K1, and assembly, end to end; then
    the gradients of a photometric loss through it (K2 and the reduction)
    vs autograd through the oracle."""
    params, state, _ = demo.demo_scene(n=600, w=64, h=64, seed=3,
                                       sh_degree=SH_DEGREE, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = params._replace(
        features_rest=0.2 * torch.randn(params.features_rest.shape,
                                        generator=gen),
        opacity=1.5 * torch.randn(params.opacity.shape, generator=gen))
    bg = torch.tensor([0.1, 0.3, 0.2])
    small = dict(capacity=1 << 13, max_per_tile=1024, fast_sort=True,
                 tight_culling=True, precise_cull=True)
    cam = demo.demo_camera(64, 64, 0.3, device="cpu")
    want = render(cam, params, state.alive, SH_DEGREE, bg,
                  rast.make_settings("xla", block_x=32, block_y=32, chunk=8,
                                     **small))
    dev = torch.device("cuda")
    got = render(demo.demo_camera(64, 64, 0.3, device=dev),
                 gm.GaussianParams(*(a.to(dev) for a in params)),
                 state.alive.to(dev), SH_DEGREE, bg.to(dev),
                 rast.make_settings("seq", **small))
    err = (got["render"].cpu() - want["render"]).abs().max().item()
    print(f"small reference: 64x64 seq on the card vs the CPU scan oracle, "
          f"max|d| {err:.3e} (atol 1e-4)")
    check(err <= 1e-4, f"card render disagrees with the CPU oracle: {err}")
    for key in ("num_rendered", "dropped", "culled", "max_per_tile"):
        check(int(got[key]) == int(want[key]), f"monitor {key} differs")

    target = torch.rand((3, 64, 64), generator=gen)
    grads = {}
    for backend, device in (("xla", "cpu"), ("seq", "cuda")):
        leaves = gm.GaussianParams(*(a.detach().to(device).requires_grad_()
                                     for a in params))
        settings = (rast.make_settings("xla", block_x=32, block_y=32, chunk=8,
                                       **small) if backend == "xla"
                    else rast.make_settings("seq", **small))
        out = render(demo.demo_camera(64, 64, 0.3, device=device), leaves,
                     state.alive.to(device), SH_DEGREE, bg.to(device),
                     settings)
        loss = losses.photometric_loss(out["render"], target.to(device), 0.2)
        grads[backend] = torch.autograd.grad(
            loss, [leaves.xyz, leaves.scaling, leaves.rotation,
                   leaves.opacity, leaves.features_dc, leaves.features_rest])
    worst = max(gate_error(g.cpu().reshape(1, -1), w.reshape(1, -1))
                for g, w in zip(grads["seq"], grads["xla"]))
    print(f"small train reference: 64x64 L1+SSIM gradients, seq on the card "
          f"vs the CPU scan oracle's autograd, max|d| / scale {worst:.3e} "
          f"(JAX gate)")


def phase_serve(params, state):
    """PLY save -> load, then render four views through the public API."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "point_cloud.ply")
        gm.save_ply(path, params, state.alive)
        loaded, lstate, deg = gm.load_ply(path, device="cuda")
    check(deg == SH_DEGREE, f"loaded SH degree {deg}")
    for a, b in zip(loaded, params):
        check(torch.equal(a, b), "PLY round trip changed a leaf")
    cams = [demo.demo_camera(W, H, angle) for angle in VIEWS]
    bg = torch.zeros(3, device="cuda")

    torch.cuda.synchronize()
    blend_seq.launches = blend_seq.bwd_launches = 0
    outs = [render(cam, loaded, lstate.alive, deg, bg, SETTINGS)
            for cam in cams]
    torch.cuda.synchronize()
    launches = blend_seq.launches
    check(launches == len(VIEWS),
          f"K1 launched {launches} times for {len(VIEWS)} renders")
    check(blend_seq.bwd_launches == 0, "a forward render launched K2")
    print(f"serve: K1 launched {launches} times for {len(VIEWS)} renders")
    for angle, out in zip(VIEWS, outs):
        img = out["render"]
        check(img.shape == (3, H, W), f"image shape {tuple(img.shape)}")
        check(torch.isfinite(img).all().item(), "image not finite")
        check(img.std().item() > 1e-3, "image is constant")
        check(int(out["dropped"]) == 0, f"dropped {int(out['dropped'])}")
        print(f"serve view {angle:.3f} rad: num_rendered "
              f"{int(out['num_rendered'])}, aligned_demand "
              f"{int(out['aligned_demand'])}, max_per_tile "
              f"{int(out['max_per_tile'])}, culled {int(out['culled'])}, "
              f"dropped 0, mean {img.mean().item():.5f}")

    # request latency (host clock to a synchronised result) and K1's device
    # time inside the same renders (CUDA events around its launches)
    k1_events = []
    kernel = blend_seq.blend_seq_fwd

    def timed_kernel(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = kernel(*args, **kw)
        e1.record()
        k1_events.append((e0, e1))
        return out

    render_ms = []
    blend_seq.blend_seq_fwd = timed_kernel
    try:
        for i in range(12):
            t0 = time.perf_counter()
            render(cams[i % len(cams)], loaded, lstate.alive, deg, bg,
                   SETTINGS)
            torch.cuda.synchronize()
            render_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        blend_seq.blend_seq_fwd = kernel
    k1_ms = [a.elapsed_time(b) for a, b in k1_events]
    print(f"serve timing over {len(render_ms) - 2} renders: median render "
          f"{statistics.median(render_ms[2:]):.3f} ms (host clock, "
          f"synchronised), median K1 {statistics.median(k1_ms[2:]):.4f} ms "
          f"(CUDA events)")
    return loaded, lstate


def perturbed(params, seed):
    """The cloud with seeded noise on its opacity logits and SH DC: where
    training starts, its target being the unperturbed cloud's renders."""
    gen = torch.Generator(device=params.xyz.device).manual_seed(seed)

    def noise(a, std):
        return std * torch.randn(a.shape, generator=gen, device=a.device)

    return params._replace(
        opacity=params.opacity + noise(params.opacity, 1.0),
        features_dc=params.features_dc + noise(params.features_dc, 0.3))


def orbit_targets(params, state, settings=SETTINGS):
    cams = [demo.demo_camera(W, H, angle) for angle in VIEWS]
    bg = torch.zeros(3, device="cuda")
    with torch.no_grad():
        gts = [render(cam, params, state.alive, SH_DEGREE, bg,
                      settings)["render"] for cam in cams]
    return cams, gts, bg


def phase_train(params, state, rows):
    """20 ``train_step``s at the bench width, from a perturbed cloud towards
    the unperturbed cloud's renders from four orbit views."""
    cams, gts, bg = orbit_targets(params, state)
    tx = optim.make_optimizer(optim.OptimizationParams(), 1.0)
    start = perturbed(params, 11)
    ts = loop.TrainState(start, state, tx.init(start), 0)
    kw = dict(tx=tx, sh_degree=SH_DEGREE, settings=SETTINGS,
              lambda_dssim=0.2)

    torch.cuda.synchronize()
    blend_seq.launches = blend_seq.bwd_launches = 0
    step_ms, metrics = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        ts, m = loop.train_step(ts, cams[i % 4], gts[i % 4], bg, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    k1, k2 = blend_seq.launches, blend_seq.bwd_launches
    check(k1 == TRAIN_STEPS and k2 == TRAIN_STEPS,
          f"{TRAIN_STEPS} steps launched K1 {k1} and K2 {k2} times")
    rows["K1"]["launches"], rows["K2"]["launches"] = k1, k2
    loss = [m["loss"].item() for m in metrics]
    check(all(math.isfinite(x) for x in loss), f"loss not finite: {loss}")
    check(all(int(m["dropped"]) == 0 for m in metrics), "instances dropped")
    for name, group in ts.opt_state.items():
        check(torch.isfinite(group.mu).all().item()
              and torch.isfinite(group.nu).all().item(),
              f"non-finite gradient moments in {name}")
    for name, leaf in zip(ts.params._fields, ts.params):
        check(torch.isfinite(leaf).all().item(), f"{name} not finite")
    first, last = statistics.mean(loss[:5]), statistics.mean(loss[-5:])
    check(last < first, f"loss did not fall: first 5 {first}, last 5 {last}")
    step = statistics.median(step_ms[2:])
    print(f"train: K1 {k1} and K2 {k2} launches in {TRAIN_STEPS} steps; loss "
          f"{loss[0]:.5f} -> {loss[-1]:.5f} (mean of first 5 {first:.5f}, "
          f"last 5 {last:.5f}); psnr {metrics[0]['psnr'].item():.3f} -> "
          f"{metrics[-1]['psnr'].item():.3f}; num_rendered "
          f"{int(metrics[-1]['num_rendered'])}, dropped 0")
    print(f"train timing: median step {step:.3f} ms (host clock, "
          f"synchronised, {TRAIN_STEPS - 2} steps), {W * H / step / 1e3:.3f} "
          f"Mpix/s")

    # bench.py's step: render + loss + backward, no optimizer
    def fwd_bwd():
        leaves = [a.detach().requires_grad_() for a in ts.params]
        out = render(cams[0], ts.params._replace(
            **dict(zip(ts.params._fields, leaves))), state.alive, SH_DEGREE,
            bg, SETTINGS)
        loss = losses.photometric_loss(out["render"], gts[0], 0.2)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    fb_ms = []
    for _ in range(12):
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        fb_ms.append((time.perf_counter() - t0) * 1e3)
    fb = statistics.median(fb_ms[2:])
    print(f"train timing: render+loss+backward (bench.py's step) median "
          f"{fb:.3f} ms, {W * H / fb / 1e3:.3f} Mpix/s fwd+bwd")

    # the same steps, with CUDA events between their stages
    split = {"forward": [], "backward": [], "optimizer": []}
    host_ms = []
    for i in range(12):
        events = []

        def mark(_stage):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        t0 = time.perf_counter()
        mark("start")
        ts, _ = loop.train_step(ts, cams[i % 4], gts[i % 4], bg, mark=mark,
                                **kw)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        for stage, a, b in zip(split, events, events[1:]):
            split[stage].append(a.elapsed_time(b))
    print("train step split (CUDA events, median of 10): " + ", ".join(
        f"{stage} {statistics.median(v[2:]):.3f} ms"
        for stage, v in split.items())
        + f"; the same steps by host clock {statistics.median(host_ms[2:]):.3f}"
        " ms")

    from torch.profiler import ProfilerActivity, profile
    steps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            ts, _ = loop.train_step(ts, cams[i % 4], gts[i % 4], bg, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, wall_ms, steps, "step")


def report_profile(prof, wall_ms, count, unit):
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print("profiler: no device time recorded")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # host calls that wait on the device (one cudaDeviceSynchronize ends
    # the window) or copy to it
    waits = {e.key: e.count for e in prof.key_averages()
             if "Synchronize" in e.key or e.key.startswith("cudaMemcpy")}
    print(f"profiler over {count} {unit}s: wall {wall_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(e.count for e in kernels) // count} kernels per {unit}; "
          f"host waits and copies in the window: {waits or 'none'}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / count:8.3f} ms/{unit} "
              f"x{e.count // count:<4d} {e.key[:90]}")


def phase_trainer():
    """``Trainer`` for 30 iterations at the bench width with densification
    at 10, 20 and 30, from a cloud with room to double."""
    params, state, _ = demo.demo_scene(n=N, w=W, h=H, sh_degree=SH_DEGREE,
                                       capacity=2 * N)
    cams, gts, _ = orbit_targets(params, state)
    model = gm.GaussianModel(SH_DEGREE)
    model.params, model.state = perturbed(params, 12), state
    model.active_sh_degree = SH_DEGREE
    opt = optim.OptimizationParams(densify_from_iter=5,
                                   densification_interval=10)
    settings = dataclasses.replace(SETTINGS, capacity=1 << 20,
                                   packed_capacity=1 << 20)
    trainer = loop.Trainer(model, opt=opt, settings=settings,
                           cameras_extent=4.4, tune_interval=10)
    fired, written_rows = [], 0
    t0 = time.perf_counter()
    for it in range(1, TRAINER_ITERS + 1):
        metrics = trainer.grad_step(cams[it % 4], gts[it % 4], it)
        alive_before = trainer.ts.gstate.alive
        metrics = trainer.apply_schedule(it, metrics)
        report = metrics.get("densify")
        if report is None:
            continue
        fired.append(it)
        alive = trainer.ts.gstate.alive
        new = alive[:alive_before.shape[0]] & ~alive_before
        written_rows += int(new.sum())
        for name, group in trainer.ts.opt_state.items():
            check(not group.mu[:new.shape[0]][new].any()
                  and not group.nu[:new.shape[0]][new].any(),
                  f"Adam moments of written rows not zero ({name})")
        print(f"trainer iteration {it}: densify cloned "
              f"{int(report.num_cloned)}, split {int(report.num_split)}, "
              f"pruned {int(report.num_pruned)}, alive "
              f"{int(report.num_alive)} of {trainer.ts.params.xyz.shape[0]}"
              f", demand {int(report.demand)}, loss "
              f"{metrics['loss'].item():.5f}, dropped "
              f"{int(metrics['dropped'])}, num_rendered "
              f"{int(metrics['num_rendered'])}"
              + (f", grew to {metrics['grew_capacity']}"
                 if "grew_capacity" in metrics else ""))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(fired == [10, 20, 30], f"densify fired at {fired}")
    check(written_rows > 0, "densification wrote no rows")
    trainer.sync_model()
    reset = loop.reset_opacity_step(trainer.ts)
    top = torch.sigmoid(reset.params.opacity).max().item()
    check(top <= 0.01 + 1e-6, f"opacity {top} after the reset")
    check(not reset.opt_state["opacity"].mu.any().item(),
          "opacity moments survive the reset")
    print(f"trainer: {TRAINER_ITERS} iterations in {wall:.2f} s, densify at "
          f"{fired}, {written_rows} rows written with zero Adam moments, "
          f"{model.num_alive} alive; reset_opacity_step leaves max opacity "
          f"{top:.6f}")


def write_colmap_copy(src: str, dst: str):
    """A COLMAP-layout copy of the Blender scene at ``src``: one PINHOLE
    camera, every train and test view in ``images.bin`` (world-to-camera
    quaternion and translation), the init cloud as ``points3D.bin`` (empty
    tracks) and the views composited over black as RGB PNGs. The demo
    tool's camera frames are mirrored (determinant -1), which no quaternion
    holds, so the copy mirrors the world in z: every rotation becomes
    proper and every image stays the same."""
    sparse = os.path.join(dst, "sparse", "0")
    images = os.path.join(dst, "images")
    os.makedirs(sparse)
    os.makedirs(images)
    views = []
    for split in ("train", "test"):
        with open(os.path.join(src, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        views += [(split, frame) for frame in meta["frames"]]
    height, width = image_io.read_png(
        os.path.join(src, views[0][1]["file_path"] + ".png")).shape[:2]
    focal = proj.fov2focal(meta["camera_angle_x"], width)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<QiiQQ", 1, 1, 1, width, height))
        f.write(struct.pack("<dddd", focal, focal, width / 2, height / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for i, (split, frame) in enumerate(views):
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1                      # OpenGL -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            rot = w2c[:3, :3] * MIRROR_Z         # R diag(1, 1, -1)
            check(np.linalg.det(rot) > 0, "improper camera rotation")
            name = f"{split}_{os.path.basename(frame['file_path'])}.png"
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *colmap_io.rotmat2qvec(rot)))
            f.write(struct.pack("<ddd", *w2c[:3, 3]))
            f.write(struct.pack("<i", 1) + name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
            rgba = image_io.read_png(
                os.path.join(src, frame["file_path"] + ".png"))
            rgb = rgba[..., :3] / 255.0 * (rgba[..., 3:] / 255.0)
            image_io.write_png(os.path.join(images, name),
                               (rgb * 255.0).astype(np.uint8))
    xyz, colors, _ = ply_io.fetch_point_cloud(
        os.path.join(src, "points3d.ply"))
    rgb = (colors * 255.0).round().astype(np.uint8)
    record = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                       ("error", "<f8"), ("track", "<u8")])
    rows = np.zeros(len(xyz), record)
    rows["id"], rows["xyz"], rows["rgb"] = (np.arange(len(xyz)),
                                            xyz * MIRROR_Z, rgb)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)) + rows.tobytes())


def phase_scene(rows):
    """The port's user path from files on disk: the demo-scene tool writes
    the 800x800 scene, ``python -m neuralgaussiansplatting_torch.train``'s
    ``main`` trains it SCENE_ITERS iterations in this process (K1 and K2
    once per iteration), a subprocess resumes from the halfway checkpoint,
    and a COLMAP-layout copy trains COLMAP_ITERS iterations at -r 2."""
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "scene"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        make_demo_scene.main(["--out", src] + SCENE_TOOL_ARGS)
        build_s = time.perf_counter() - t0

        pngs = sorted(os.path.join(src, "train", f)
                      for f in os.listdir(os.path.join(src, "train")))
        t0 = time.perf_counter()
        first = [image_io.read_png(p) for p in pngs][0]
        up_ms = (time.perf_counter() - t0) * 1e3 / len(pngs)
        decode_ms = {}
        for name, kind in (("Average", 3), ("Paeth", 4)):
            data = image_io.encode_png(first, kind)
            t0 = time.perf_counter()
            check((image_io.decode_png(data) == first).all(),
                  f"PNG decode of the {name}-filtered image")
            decode_ms[name] = (time.perf_counter() - t0) * 1e3
        h, w = first.shape[:2]
        print(f"scene: the demo-scene tool wrote the scene ({' '.join(
              SCENE_TOOL_ARGS)}) in {build_s:.2f} s; PNG decode of a "
              f"{w}x{h} RGBA image: {up_ms:.2f} ms per image (Up filter, "
              f"the tool's; mean of {len(pngs)}), "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in decode_ms.items()))

        torch.cuda.synchronize()
        reset_launch_counts()
        summary = train_entry.main(
            ["-s", src, "-m", out, "--iterations", str(SCENE_ITERS),
             "--test_iterations", "1", str(SCENE_ITERS), "--save_iterations",
             str(SCENE_ITERS), "--checkpoint_iterations",
             str(SCENE_CHECKPOINT), "--quiet"] + SCENE_TRAIN_ARGS)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts["K1"] >= SCENE_ITERS and counts["K2"] == SCENE_ITERS,
              f"{SCENE_ITERS} iterations launched {counts}")
        check(counts["K4"] == counts["K5"] == 0,
              f"the seq entry point reached the pallas kernels: {counts}")
        rows["K1"]["scene_launches"] = counts["K1"]
        rows["K2"]["scene_launches"] = counts["K2"]
        psnr = {it: summary["evals"][it]["test"][1]
                for it in (1, SCENE_ITERS)}
        check(psnr[SCENE_ITERS] >= psnr[1] + SCENE_PSNR_GAIN,
              f"test PSNR {psnr[1]:.3f} -> {psnr[SCENE_ITERS]:.3f} dB "
              f"gained less than {SCENE_PSNR_GAIN} dB")
        tune_it, dropped = summary["tune"][-1]
        check(dropped == 0, f"{dropped} instances dropped at the tune point "
              f"{tune_it}")
        check(math.isfinite(summary["last_loss"]),
              f"last loss {summary['last_loss']}")
        for name in SCENE_FILES:
            check(os.path.exists(os.path.join(out, name)),
                  f"the entry point wrote no {name}")
        print(f"scene train: {SCENE_ITERS} iterations through the entry "
              f"point in {summary['wall_s']:.2f} s, median iteration "
              f"{summary['median_iter_ms']:.3f} ms (host clock, "
              f"{len(summary['iter_ms'])} iterations without densify, "
              f"evaluation or file writes); K1 {counts['K1']}, K2 "
              f"{counts['K2']} launches; test PSNR {psnr[1]:.3f} -> "
              f"{psnr[SCENE_ITERS]:.3f} dB (train views "
              f"{summary['evals'][1]['train'][1]:.3f} -> "
              f"{summary['evals'][SCENE_ITERS]['train'][1]:.3f}); dropped 0 "
              f"at the tune point {tune_it}; last loss "
              f"{summary['last_loss']:.6f}")

        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "neuralgaussiansplatting_torch.train",
             "-s", src, "-m", out, "--iterations", str(SCENE_ITERS),
             "--test_iterations", str(SCENE_ITERS), "--save_iterations",
             str(SCENE_ITERS), "--start_checkpoint",
             os.path.join(out, f"chkpnt{SCENE_CHECKPOINT}.ckpt")]
            + SCENE_TRAIN_ARGS, cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        resume_s = time.perf_counter() - t0
        check(res.returncode == 0, f"resume exited {res.returncode}: "
              f"{res.stdout[-1500:]}\n{res.stderr[-3000:]}")
        check(f"at iteration {SCENE_CHECKPOINT}" in res.stdout,
              f"the resume did not start at {SCENE_CHECKPOINT}")
        last = [line for line in res.stdout.splitlines()
                if line.startswith("last loss ")]
        check(last and math.isfinite(float(last[-1].split()[2])),
              f"the resume ended without a finite loss: {last}")
        print(f"scene resume: a subprocess resumed at iteration "
              f"{SCENE_CHECKPOINT} and ran to {SCENE_ITERS} in "
              f"{resume_s:.2f} s; {last[-1].split(' [')[0]}; "
              + "; ".join(line.split(" [")[0] for line in
                          res.stdout.splitlines() if "Evaluating" in line))

        colmap = os.path.join(tmp, "colmap")
        t0 = time.perf_counter()
        write_colmap_copy(src, colmap)
        copy_s = time.perf_counter() - t0
        reset_launch_counts()
        t0 = time.perf_counter()
        csummary = train_entry.main(
            ["-s", colmap, "-m", os.path.join(tmp, "colmap_out"), "-r", "2",
             "--eval", "--iterations", str(COLMAP_ITERS),
             "--test_iterations", str(COLMAP_ITERS), "--save_iterations",
             str(COLMAP_ITERS), "--disable_viewer", "--quiet"])
        torch.cuda.synchronize()
        colmap_s = time.perf_counter() - t0
        counts = launch_counts()
        check(counts["K1"] >= COLMAP_ITERS and counts["K2"] == COLMAP_ITERS,
              f"the COLMAP run launched {counts}")
        check(math.isfinite(csummary["last_loss"]),
              f"COLMAP run: last loss {csummary['last_loss']}")
        cpsnr = csummary["evals"][COLMAP_ITERS]["test"][1]
        check(math.isfinite(cpsnr), f"COLMAP run: test PSNR {cpsnr}")
        print(f"scene COLMAP: copy written in {copy_s:.2f} s; -r 2 "
              f"{COLMAP_ITERS} iterations in {colmap_s:.2f} s including the "
              f"scene load (native points3D parse: "
              f"{'yes' if native.available() else 'no, Python'}), test PSNR "
              f"{cpsnr:.3f}, last loss {csummary['last_loss']:.6f}")
    print(f"scene card: {card_line()}")


def phase_breakdown(params, state):
    """Where a render's time goes: the stages of ``rasterize`` timed apart
    with CUDA events, then the device's busy share over whole renders and
    its top kernels from torch.profiler."""
    cam = demo.demo_camera(W, H)
    stages = ("preprocess", "bin", "pack", "K1")
    times = {stage: [] for stage in stages}
    for _ in range(12):
        events = []

        def mark(_stage):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        mark("start")
        packed, inst, tiles_x = k1_inputs(params, state, cam, mark)
        blend_seq.blend_seq_fwd(packed, inst.tile_start, inst.tile_count,
                                tiles_x)
        mark("K1")
        torch.cuda.synchronize()
        for stage, a, b in zip(stages, events, events[1:]):
            times[stage].append(a.elapsed_time(b))
    print("stage breakdown (CUDA events, median of 10): " + ", ".join(
        f"{stage} {statistics.median(v[2:]):.3f} ms"
        for stage, v in times.items()))

    from torch.profiler import ProfilerActivity, profile
    bg = torch.zeros(3, device="cuda")
    renders = 5
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(renders):
            render(cam, params, state.alive, SH_DEGREE, bg, SETTINGS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, wall_ms, renders, "render")


def render_latency(cams, params, alive, settings, count=12):
    """Median of the last ``count - 2`` renders' latency in ms (host clock
    to a synchronised image)."""
    bg = torch.zeros(3, device="cuda")
    times = []
    with torch.no_grad():
        for i in range(count):
            t0 = time.perf_counter()
            render(cams[i % len(cams)], params, alive, SH_DEGREE, bg,
                   settings)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[2:])


def phase_pallas_serve(params, state):
    """The pallas path at the bench width: capacities from a probe, four
    views through ``render`` (K4 once per render), a 16x16 seq setting
    routed to K4 and bit-equal to the pallas render, latency and the
    profiler over renders. Returns the sized settings."""
    cams = [demo.demo_camera(W, H, angle) for angle in VIEWS]
    bg = torch.zeros(3, device="cuda")
    settings, probe = sized_settings(PALLAS_PROBE, params, state.alive,
                                     cams[0])
    print(f"pallas settings: {settings.block_x}x{settings.block_y} tiles, "
          f"chunk {settings.chunk}, capacity {settings.capacity}, "
          f"packed_capacity {settings.packed_capacity} from a probe render "
          f"(num_rendered {int(probe['num_rendered'])}, aligned_demand "
          f"{int(probe['aligned_demand'])})")

    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.no_grad():
        outs = [render(cam, params, state.alive, SH_DEGREE, bg, settings)
                for cam in cams]
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == {"K1": 0, "K2": 0, "K4": len(VIEWS), "K5": 0},
          f"{len(VIEWS)} pallas renders launched {counts}")
    print(f"pallas serve: {len(VIEWS)} renders launched {counts}")
    for angle, out in zip(VIEWS, outs):
        img = out["render"]
        check(img.shape == (3, H, W), f"image shape {tuple(img.shape)}")
        check(torch.isfinite(img).all().item(), "image not finite")
        check(img.std().item() > 1e-3, "image is constant")
        check(int(out["dropped"]) == 0, f"dropped {int(out['dropped'])}")
        print(f"pallas serve view {angle:.3f} rad: num_rendered "
              f"{int(out['num_rendered'])}, aligned_demand "
              f"{int(out['aligned_demand'])}, max_per_tile "
              f"{int(out['max_per_tile'])}, culled {int(out['culled'])}, "
              f"dropped 0, mean {img.mean().item():.5f}")

    seq16 = dataclasses.replace(settings, backend="seq")
    reset_launch_counts()
    with torch.no_grad():
        routed = render(cams[0], params, state.alive, SH_DEGREE, bg, seq16)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == {"K1": 0, "K2": 0, "K4": 1, "K5": 0},
          f"a 16x16 seq render launched {counts}")
    check(torch.equal(routed["render"], outs[0]["render"]),
          "the 16x16 seq render differs from the pallas render")
    print(f"pallas serve: a 16x16 seq render launched {counts}; its image "
          "is bit-equal to the pallas render's")

    latency = render_latency(cams, params, state.alive, settings)
    print(f"pallas serve timing: median render {latency:.3f} ms over 10 "
          f"renders (host clock, synchronised), {W * H / latency / 1e3:.3f} "
          "Mpix/s")
    from torch.profiler import ProfilerActivity, profile
    renders = 5
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(renders):
            render(cams[i % len(cams)], params, state.alive, SH_DEGREE, bg,
                   settings)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, wall_ms, renders, "render")
    return settings


def phase_pallas_train(params, state):
    """``train_step``s on the pallas path at the bench width, from the
    perturbed cloud towards the unperturbed cloud's pallas renders of the
    four orbit views. Returns K4's and K5's launches in them."""
    cams = [demo.demo_camera(W, H, angle) for angle in VIEWS]
    start = perturbed(params, 11)
    settings, _ = sized_settings(PALLAS_PROBE, start, state.alive, cams[0])
    _, gts, bg = orbit_targets(params, state, settings)
    tx = optim.make_optimizer(optim.OptimizationParams(), 1.0)
    ts = loop.TrainState(start, state, tx.init(start), 0)
    kw = dict(tx=tx, sh_degree=SH_DEGREE, settings=settings,
              lambda_dssim=0.2)

    torch.cuda.synchronize()
    reset_launch_counts()
    step_ms, metrics = [], []
    for i in range(PALLAS_STEPS):
        t0 = time.perf_counter()
        ts, m = loop.train_step(ts, cams[i % 4], gts[i % 4], bg, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    counts = launch_counts()
    check(counts == {"K1": 0, "K2": 0, "K4": PALLAS_STEPS,
                     "K5": PALLAS_STEPS},
          f"{PALLAS_STEPS} pallas steps launched {counts}")
    loss = [m["loss"].item() for m in metrics]
    check(all(math.isfinite(x) for x in loss), f"loss not finite: {loss}")
    check(all(int(m["dropped"]) == 0 for m in metrics), "instances dropped")
    for name, leaf in zip(ts.params._fields, ts.params):
        check(torch.isfinite(leaf).all().item(), f"{name} not finite")
    first, last = statistics.mean(loss[:3]), statistics.mean(loss[-3:])
    check(last < first, f"loss did not fall: first 3 {first}, last 3 {last}")
    step = statistics.median(step_ms[2:])
    print(f"pallas train: {counts} in {PALLAS_STEPS} steps; loss "
          f"{loss[0]:.5f} -> {loss[-1]:.5f} (mean of first 3 {first:.5f}, "
          f"last 3 {last:.5f}); psnr {metrics[0]['psnr'].item():.3f} -> "
          f"{metrics[-1]['psnr'].item():.3f}; num_rendered "
          f"{int(metrics[-1]['num_rendered'])}, dropped 0")
    print(f"pallas train timing: median step {step:.3f} ms (host clock, "
          f"synchronised, {PALLAS_STEPS - 2} steps), "
          f"{W * H / step / 1e3:.3f} Mpix/s")

    from torch.profiler import ProfilerActivity, profile
    steps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            ts, _ = loop.train_step(ts, cams[i % 4], gts[i % 4], bg, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, wall_ms, steps, "step")
    return counts["K4"], counts["K5"]


def phase_garden():
    """The garden regime on the pallas path: monitors, 3 forward renders, 2
    render + L1+SSIM + backward passes with finite gradients, and the image
    against the seq (32x32) render of the same cloud at the tiling band
    gate; peak memory. Then ``garden_seq`` with the seq settings; returns
    its rows."""
    t0 = time.perf_counter()
    params, state, cam = demo.demo_scene(n=GARDEN_N, w=GARDEN_W, h=GARDEN_H,
                                         seed=3, sh_degree=SH_DEGREE)
    params = params._replace(scaling=params.scaling - 2.2)
    torch.cuda.synchronize()
    print(f"garden scene: {GARDEN_N} points at {GARDEN_W}x{GARDEN_H} built "
          f"in {time.perf_counter() - t0:.1f} s (host kNN included)")
    torch.cuda.reset_peak_memory_stats()
    settings, _ = sized_settings(GARDEN_PROBE, params, state.alive, cam)
    bg = torch.zeros(3, device="cuda")
    mpix = GARDEN_W * GARDEN_H / 1e6

    reset_launch_counts()
    fwd_ms = []
    with torch.no_grad():
        for _ in range(4):
            t0 = time.perf_counter()
            out = render(cam, params, state.alive, SH_DEGREE, bg, settings)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    check(counts == {"K1": 0, "K2": 0, "K4": 4, "K5": 0},
          f"4 garden renders launched {counts}")
    monitors = {k: int(out[k]) for k in ("num_rendered", "aligned_demand",
                                          "culled", "dropped",
                                          "max_per_tile")}
    print(f"garden monitors: {monitors}; capacity {settings.capacity}, "
          f"packed_capacity {settings.packed_capacity}")
    check(monitors["dropped"] == 0, f"garden dropped {monitors['dropped']}")
    img = out["render"]
    check(torch.isfinite(img).all().item() and img.std().item() > 1e-3,
          "garden image not finite or constant")
    print("garden forward (host clock, synchronised; the first render "
          "warms up): " + ", ".join(
              f"{ms:.3f} ms ({mpix / ms * 1e3:.3f} Mpix/s)"
              for ms in fwd_ms[1:]))

    gen = torch.Generator(device="cuda").manual_seed(5)
    target = torch.rand((3, GARDEN_H, GARDEN_W), generator=gen,
                        device="cuda")

    def fwd_bwd():
        leaves = [a.detach().requires_grad_() for a in params]
        out = render(cam, gm.GaussianParams(*leaves), state.alive, SH_DEGREE,
                     bg, settings)
        loss = losses.photometric_loss(out["render"], target, 0.2)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    fb_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        grads = fwd_bwd()
        torch.cuda.synchronize()
        fb_ms.append((time.perf_counter() - t0) * 1e3)
        for name, g in zip(gm.GaussianParams._fields, grads):
            check(g is None or torch.isfinite(g).all().item(),
                  f"garden gradient of {name} not finite")
    counts = launch_counts()
    check(counts["K5"] == 2 and counts["K1"] == counts["K2"] == 0,
          f"garden fwd+bwd launched {counts}")
    print("garden render + L1+SSIM + backward (host clock, synchronised): "
          + ", ".join(f"{ms:.3f} ms ({mpix / ms * 1e3:.3f} Mpix/s)"
                      for ms in fb_ms) + "; every gradient finite")

    from torch.profiler import ProfilerActivity, profile
    for unit, fn in (("render", lambda: render(cam, params, state.alive,
                                               SH_DEGREE, bg, settings)),
                     ("fwd+bwd", fwd_bwd)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        print(f"garden {unit}:", end=" ")
        report_profile(prof, wall_ms, 2, unit)

    wide = dataclasses.replace(settings, max_per_tile=8192)
    seq, _ = sized_settings(
        rast.make_settings("seq", capacity=GARDEN_PROBE.capacity,
                           max_per_tile=8192, fast_sort=True,
                           tight_culling=True, precise_cull=True),
        params, state.alive, cam)
    with torch.no_grad():
        a = render(cam, params, state.alive, SH_DEGREE, bg, wide)
        b = render(cam, params, state.alive, SH_DEGREE, bg, seq)
    check(int(a["dropped"]) == 0 and int(b["dropped"]) == 0,
          f"cross-check dropped {int(a['dropped'])} (pallas), "
          f"{int(b['dropped'])} (seq)")
    diff = (a["render"] - b["render"]).abs()
    worst, mean = diff.max().item(), diff.mean().item()
    print(f"garden vs seq 32x32 (max_per_tile 8192 on both, dropped 0): "
          f"max|d| {worst:.3e}, mean|d| {mean:.3e} (band gate: < "
          f"{BAND_GATE[0]}, < {BAND_GATE[1]})")
    check(worst < BAND_GATE[0] and mean < BAND_GATE[1],
          "garden image outside the 16x16 / 32x32 tiling band gate")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"garden: peak memory {peak:.2f} GiB")
    rows = garden_pallas(params, state, cam, settings)
    rows.update(garden_seq(params, state, cam, seq))
    return rows


def garden_pallas(params, state, cam, settings):
    """The 16x16 pallas path at the garden shapes: a tile-load line, K4 and
    K5 against their plain versions on one view at the gates of the bench
    shapes (the plain versions timed by their one parity run), their device
    times and bounds. Returns {"K4": ..., "K5": ...}: each kernel's garden
    numbers."""
    tile = (settings.block_x, settings.block_y)
    packed, inst, tiles_x = k1_inputs(params, state, cam, settings=settings)
    tile_load(f"garden {GARDEN_W}x{GARDEN_H} {tile[0]}x{tile[1]}",
              inst.tile_count, blend_pallas.blend_pallas_fwd(
                  packed, inst.tile_start, inst.tile_count, tiles_x, *tile))
    return {"K4": parity_entry(k4_numbers("k4 garden", packed, inst, tiles_x,
                                          tile, plain_reps=0),
                               inst.tile_count),
            "K5": parity_entry(k5_numbers("k5 garden", packed, inst, tiles_x,
                                          tile, size=(GARDEN_W, GARDEN_H),
                                          plain_reps=0),
                               inst.tile_count)}


def garden_seq(params, state, cam, settings):
    """The 32x32 seq path at the garden shapes: K1 and K2 against their
    plain versions on one view at the gates of the bench shapes (the plain
    versions timed by their one parity run), their device times and bounds,
    and one seq render and one render + L1+SSIM + backward (host clock).
    Returns {"K1": ..., "K2": ...}: each kernel's garden numbers."""
    size = (GARDEN_W, GARDEN_H)
    packed, inst, tiles_x = k1_inputs(params, state, cam, settings=settings)
    args = (packed, inst.tile_start, inst.tile_count, tiles_x)
    tile_load(f"garden {GARDEN_W}x{GARDEN_H}", inst.tile_count,
              blend_seq.blend_seq_fwd(*args))
    tile = (blend_seq.BX, blend_seq.BY)
    rows = {
        "K1": parity_entry(fwd_parity(
            "k1 garden", blend_seq.blend_seq_fwd,
            blend_seq.blend_tiles_seq_reference, args, blend_seq.PIX,
            pair_ops("k1", K1_BLEND_OPS_PER_PAIR, tile, "seq"),
            plain_reps=0), inst.tile_count),
        "K2": parity_entry(bwd_parity(
            "k2 garden", blend_seq.blend_seq_fwd, blend_seq.blend_seq_bwd,
            blend_seq.blend_tiles_seq_bwd_reference, packed, inst,
            (tiles_x,), tile,
            pair_ops("k2", K2_BLEND_OPS_PER_PAIR, tile, "seq"), size=size,
            plain_reps=0), inst.tile_count)}
    del packed, inst

    bg = torch.zeros(3, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    target = torch.rand((3, GARDEN_H, GARDEN_W), generator=gen,
                        device="cuda")
    mpix = GARDEN_W * GARDEN_H / 1e6

    def fwd_bwd():
        leaves = [a.detach().requires_grad_() for a in params]
        out = render(cam, gm.GaussianParams(*leaves), state.alive, SH_DEGREE,
                     bg, settings)
        loss = losses.photometric_loss(out["render"], target, 0.2)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    reset_launch_counts()
    fwd_ms, fb_ms = [], []
    with torch.no_grad():
        for _ in range(3):
            t0 = time.perf_counter()
            render(cam, params, state.alive, SH_DEGREE, bg, settings)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        t0 = time.perf_counter()
        grads = fwd_bwd()
        torch.cuda.synchronize()
        fb_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    check(counts == {"K1": 6, "K2": 3, "K4": 0, "K5": 0},
          f"3 garden seq renders and 3 fwd+bwd launched {counts}")
    check(all(g is None or torch.isfinite(g).all().item() for g in grads),
          "garden seq gradient not finite")
    print(f"garden seq (32x32, max_per_tile {settings.max_per_tile}; "
          f"launches {counts}): render "
          + ", ".join(f"{ms:.3f}" for ms in fwd_ms[1:])
          + " ms; render + L1+SSIM + backward "
          + ", ".join(f"{ms:.3f}" for ms in fb_ms[1:])
          + f" ms (host clock, synchronised, after one warm-up each; "
          f"{mpix / statistics.median(fb_ms[1:]) * 1e3:.3f} Mpix/s fwd+bwd)")
    for name, row in rows.items():
        row["render_ms"] = fwd_ms[1:]
        row["fwd_bwd_ms"] = fb_ms[1:]
    return rows


def neural_scene():
    """The neural workload's cloud on the card, with seeded features."""
    params, state, _ = demo.demo_scene(n=N, w=W, h=H, sh_degree=NEURAL_SH)
    gen = torch.Generator(device="cuda").manual_seed(21)
    return params._replace(features=torch.randn(
        params.features.shape, generator=gen, device="cuda")), state


def k3_covered_pairs(rects, tile_start, tile_count, tiles_x) -> int:
    """The (instance, pixel) pairs of K3's input where the instance's rect
    covers a pixel of its tile."""
    count = tile_count.long()
    tile = torch.repeat_interleave(
        torch.arange(count.shape[0], device=count.device), count)
    first = torch.cumsum(count, 0) - count
    col = (torch.repeat_interleave(tile_start.long(), count)
           + torch.arange(tile.shape[0], device=count.device)
           - torch.repeat_interleave(first, count))
    x0, y0, x1, y1 = rects[:4, col].long()
    tx = (tile % tiles_x) * zbuffer_pallas.BX
    ty = (tile // tiles_x) * zbuffer_pallas.BY
    cover_x = (torch.minimum(x1, tx + zbuffer_pallas.BX)
               - torch.maximum(x0, tx)).clamp_min(0)
    cover_y = (torch.minimum(y1, ty + zbuffer_pallas.BY)
               - torch.maximum(y0, ty)).clamp_min(0)
    return int((cover_x * cover_y).sum())


def phase_k3_parity(params, state):
    """K3 vs its plain version on the card at the neural workload's shapes,
    and the tiled idxmap vs the per-pixel sort oracle."""
    cam = demo.demo_camera(W, H)
    args, _, demand = zbuffer_pallas.zbuf_inputs(params.xyz, cam,
                                                 TILE_CAPACITY, state.alive)
    rects, depth, tile_start, tile_count, tiles_x = args
    idx_t = zbuffer_pallas.compute_idxmap_tiled(params.xyz, cam,
                                                TILE_CAPACITY, state.alive)[0]
    got = zbuffer_pallas.zbuf_tiles(*args)
    torch.cuda.synchronize()
    want = zbuffer_pallas.zbuf_tiles_reference(*args)
    ids_equal = torch.equal(got[0], want[0])
    bits_equal = torch.equal(got[1].view(torch.int32),
                             want[1].view(torch.int32))
    err = (got[1] - want[1]).abs().max().item()
    idx_o, _, num_inst = idxmap_ops.compute_idxmap(params.xyz, cam,
                                                   ORACLE_CAPACITY,
                                                   state.alive)
    n_inst = int(tile_count.sum())
    num_tiles = tile_count.shape[0]
    hit_rate = (idx_t >= 0).float().mean().item()
    print(f"k3 parity: tiles {num_tiles}, K {rects.shape[1]}, instances "
          f"{n_inst} (demand {int(demand)} of {TILE_CAPACITY}), most in a "
          f"tile {int(tile_count.max())}; ids equal {ids_equal}, depths "
          f"bit-equal {bits_equal}; oracle pixel instances {int(num_inst)} "
          f"of {ORACLE_CAPACITY}; hit rate {hit_rate:.4f}")
    check(ids_equal and bits_equal, "K3 disagrees with its plain version")
    check(int(demand) <= TILE_CAPACITY, f"tile demand {int(demand)}")
    check(int(num_inst) <= ORACLE_CAPACITY,
          f"oracle demand {int(num_inst)} past its capacity")
    check(torch.equal(idx_t, idx_o), "tiled idxmap differs from the oracle")
    print("k3 parity: tiled idxmap equal to the per-pixel sort oracle at "
          "every pixel")

    ms = device_ms(lambda: zbuffer_pallas.zbuf_tiles(*args), reps=50)
    dispatch_ms = cuda_ms(lambda: zbuffer_pallas.zbuf_tiles(*args), reps=50)
    plain_ms = cuda_ms(
        lambda: zbuffer_pallas.zbuf_tiles_reference(*args), reps=2)
    pairs = k3_covered_pairs(rects, tile_start, tile_count, tiles_x)
    check(pairs == int(num_inst), f"{pairs} covered pairs, the oracle "
          f"expanded {int(num_inst)} pixel instances")
    ops = pairs * K3_OPS_PER_PAIR
    nbytes = ((zbuffer_pallas.RECT_ROWS + 1) * 4 * n_inst + 2 * num_tiles * 4
              + 2 * num_tiles * zbuffer_pallas.PIX * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    print(f"k3 timing: {ms:.4f} ms/launch (device time, 50 launches), "
          f"{dispatch_ms:.4f} ms/launch (CUDA events, 50 back to back), "
          f"plain version {plain_ms:.1f} ms; {pairs} covered (instance, "
          f"pixel) pairs (the oracle's pixel instances {int(num_inst)}; the "
          f"kernel walks them; a test of every pixel against every "
          f"instance of its tile would make {n_inst * zbuffer_pallas.PIX})"
          f" x {K3_OPS_PER_PAIR} ops = "
          f"{ops:.4g} ops at the FP32 rate "
          f"-> {t_ops:.4f} ms; {nbytes} bytes -> {t_bytes:.4f} ms")
    return kernel_row("zbuffer_fwd", "zbuffer_fwd.cu",
                      "neuralgaussiansplatting_tpu/ops/zbuffer_pallas.py:47",
                      err, ms, dispatch_ms, plain_ms, t_bytes, t_ops)


def phase_small_neural_reference():
    """The neural path on the card vs on the CPU (K3's plain version) at
    64x64 with narrow decoders: idxmap, feature map, the features' gradient
    and render1/2/3."""
    params, state, _ = demo.demo_scene(n=600, w=64, h=64, seed=3,
                                       sh_degree=NEURAL_SH, device="cpu")
    gen = torch.Generator().manual_seed(4)
    params = params._replace(features=torch.randn(params.features.shape,
                                                  generator=gen))
    narrow = {"mlp": nets.FeatureToRGBMLP(hidden_features=32),
              "unet": nets.UNet(base_channels=8),
              "cnn": nets.CNN(mid_channels=16),
              "pure_cnn": nets.PureCNN(mid_channels=16)}
    for module in narrow.values():
        nets.kaiming_init_(module, gen)
    cot = torch.randn((64, 64, idxmap_ops.NUM_FEATURES), generator=gen)
    dev = torch.device("cuda")
    sides = {
        "cpu": (params, state.alive, narrow,
                demo.demo_camera(64, 64, 0.3, device="cpu")),
        "cuda": (gm.GaussianParams(*(a.to(dev) for a in params)),
                 state.alive.to(dev),
                 {k: copy.deepcopy(m).to(dev) for k, m in narrow.items()},
                 demo.demo_camera(64, 64, 0.3, device=dev)),
    }
    maps, grads = {}, {}
    for side, (p, alive, _, cam) in sides.items():
        for _ in range(2 if side == "cuda" else 1):
            f = p.features.detach().clone().requires_grad_()
            maps[side] = idxmap_ops.render_idxmaps(p.xyz, f, cam, 1 << 13,
                                                   alive)
            (maps[side].featuremap * cot.to(f.device)).sum().backward()
            grads.setdefault(side, []).append(f.grad)
    check(torch.equal(maps["cuda"].idxmap.cpu(), maps["cpu"].idxmap),
          "idxmap differs between the card and the CPU")
    fmap_err = (maps["cuda"].featuremap.detach().cpu()
                - maps["cpu"].featuremap.detach()).abs().max().item()
    g_cpu = grads["cpu"][0]
    g_err = ((grads["cuda"][0].cpu() - g_cpu).abs().max().item()
             / g_cpu.abs().max().item())
    check(fmap_err <= 1e-6, f"feature map differs by {fmap_err}")
    check(g_err <= 1e-6, f"feature gradient differs by {g_err} of its scale")
    check(torch.equal(grads["cuda"][0], grads["cuda"][1]),
          "two backward passes on the card differ")

    want = {}
    with torch.no_grad():
        p, alive, dec, cam = sides["cpu"]
        for sw, fn in neural_loop.RENDER_FNS.items():
            want[sw] = fn(cam, p, dec, 1 << 13, alive=alive)["render"]

    def render_errors():
        errs = {}
        with torch.no_grad():
            p, alive, dec, cam = sides["cuda"]
            for sw, fn in neural_loop.RENDER_FNS.items():
                got = fn(cam, p, dec, 1 << 13, alive=alive)["render"].cpu()
                errs[sw] = ((got - want[sw]).abs().max().item()
                            / want[sw].abs().max().item())
        return errs

    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        strict = render_errors()
    finally:
        cudnn.allow_tf32 = saved
    default = render_errors()
    print(f"small neural reference: 64x64 card vs CPU: idxmap equal, feature "
          f"map max|d| {fmap_err:.3e} (1e-6), features gradient max|d| / "
          f"scale {g_err:.3e} (1e-6), two card backward passes bit-equal; "
          "render1/2/3 max|d| / scale with cuDNN TF32 off "
          + ", ".join(f"{e:.3e}" for e in strict.values())
          + " (1e-5), at PyTorch's defaults (cuDNN TF32 "
          f"{saved}) " + ", ".join(f"{e:.3e}" for e in default.values()))
    for sw, e in strict.items():
        check(e <= 1e-5, f"render{sw} on the card differs by {e} of scale")


def phase_neural_serve(params, state):
    """render1/2/3 from four cameras with full-width decoders."""
    cams = [demo.demo_camera(W, H, angle) for angle in VIEWS]
    decoders = gr.init_decoders(0, device="cuda")
    paths = {"render1": gr.render1, "render2": gr.render2,
             "render3": gr.render3}

    def run(fn, cam):
        return fn(cam, params, decoders, TILE_CAPACITY, alive=state.alive)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zbuffer_pallas.launches = 0
    with torch.no_grad():
        outs = {name: [run(fn, cam) for cam in cams]
                for name, fn in paths.items()}
    torch.cuda.synchronize()
    launches = zbuffer_pallas.launches
    renders = len(paths) * len(cams)
    check(launches == renders, f"K3 launched {launches} times for "
          f"{renders} renders")
    for name, results in outs.items():
        for out in results:
            img = out["render"]
            check(img.shape == (3, H, W), f"{name} shape {tuple(img.shape)}")
            check(torch.isfinite(img).all().item(), f"{name} not finite")
            check(int(out["num_inst"]) <= TILE_CAPACITY,
                  f"{name} z-buffer demand {int(out['num_inst'])}")
        print(f"neural serve {name}: 4 views, hit rate "
              + ", ".join(f"{(o['idxmap'] >= 0).float().mean().item():.4f}"
                          for o in results)
              + f"; demand {int(results[0]['num_inst'])}; image mean "
              f"{results[0]['render'].mean().item():.4f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"neural serve: K3 launched {launches} times for {renders} "
          f"renders; peak memory {peak:.2f} GiB")

    latency = {}
    with torch.no_grad():
        for name, fn in paths.items():
            times = []
            for i in range(8):
                t0 = time.perf_counter()
                run(fn, cams[i % len(cams)])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            latency[name] = statistics.median(times[2:])
    print("neural serve latency (median of 6, host clock, synchronised): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in latency.items()))

    # render2's stages by CUDA events around the z-buffer + feature map and
    # the denoiser; the decoders run between them
    events = []

    def timed(fn):
        def wrapper(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            events.append((e0, e1))
            return out
        return wrapper

    real = idxmap_ops.render_idxmaps, nets.denoise
    idxmap_ops.render_idxmaps, nets.denoise = map(timed, real)
    split = {"idxmap": [], "decoders": [], "denoise": []}
    try:
        with torch.no_grad():
            for i in range(8):
                events.clear()
                run(gr.render2, cams[i % len(cams)])
                torch.cuda.synchronize()
                (i0, i1), (d0, d1) = events
                split["idxmap"].append(i0.elapsed_time(i1))
                split["decoders"].append(i1.elapsed_time(d0))
                split["denoise"].append(d0.elapsed_time(d1))
    finally:
        idxmap_ops.render_idxmaps, nets.denoise = real
    print("render2 split (CUDA events, median of 6): " + ", ".join(
        f"{k} {statistics.median(v[2:]):.3f} ms" for k, v in split.items()))

    from torch.profiler import ProfilerActivity, profile
    n_renders = 5
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_renders):
            run(gr.render2, cams[i % len(cams)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, wall_ms, n_renders, "render2")


def phase_neural_train(params, state):
    """10 ``NeuralTrainer(sw=2)`` steps towards the classic render (K1) of
    the same cloud. Returns K3's launches in them."""
    cam = demo.demo_camera(W, H)
    with torch.no_grad():
        gt = render(cam, params, state.alive, NEURAL_SH,
                    torch.zeros(3, device="cuda"), SETTINGS)["render"]
    model = gm.GaussianModel(NEURAL_SH)
    model.params, model.state = params, state
    trainer = neural_loop.NeuralTrainer(model, sw=2, capacity=TILE_CAPACITY)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zbuffer_pallas.launches = 0
    step_ms, metrics = [], []
    for _ in range(NEURAL_STEPS):
        t0 = time.perf_counter()
        metrics.append(trainer.step(cam, gt))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = zbuffer_pallas.launches
    check(launches == NEURAL_STEPS,
          f"{NEURAL_STEPS} steps launched K3 {launches} times")
    loss = [m["loss"].item() for m in metrics]
    check(all(math.isfinite(x) for x in loss), f"loss not finite: {loss}")
    check(torch.isfinite(trainer.ts.params.features).all().item(),
          "features not finite")
    for name, p in neural_loop.decoder_leaves(trainer.ts.net_params).items():
        check(torch.isfinite(p).all().item(), f"decoder {name} not finite")
    first, last = statistics.mean(loss[:3]), statistics.mean(loss[-3:])
    # the loss bursts at step 2 (Adam's first step on random decoders, as
    # in JAX: tests/test_torch_neural_train.py), so the last step must also
    # end below the first
    check(last < first and loss[-1] < loss[0],
          f"loss did not fall: {loss[0]} -> {loss[-1]}, first 3 {first}, "
          f"last 3 {last}")
    step = statistics.median(step_ms[2:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"neural train: NeuralTrainer(sw=2), K3 {launches} launches in "
          f"{NEURAL_STEPS} steps; loss {loss[0]:.5f} -> {loss[-1]:.5f} (mean "
          f"of first 3 {first:.5f}, last 3 {last:.5f}); psnr "
          f"{metrics[0]['psnr'].item():.3f} -> "
          f"{metrics[-1]['psnr'].item():.3f}; hit rate "
          f"{metrics[-1]['hit_rate'].item():.4f}")
    print(f"neural train timing: median step {step:.3f} ms (host clock, "
          f"synchronised, {NEURAL_STEPS - 2} steps), {W * H / step / 1e3:.3f} "
          f"Mpix/s; peak memory {peak:.2f} GiB")
    return launches


def k6_bound(starts, domain):
    """(bound by bytes, bound by operations) in ms of decoding f = K6_F
    columns of ``starts``' runs over ``domain`` slots."""
    n_in = int((starts < domain).sum())
    nbytes = 4 * n_in * (1 + K6_F) + 4 * K6_F * domain
    ops = (n_in + domain) * K6_F
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3


def phase_k6():
    """K6 vs its plain version and ``binning._expand_runs`` at the decode
    tool's two workloads (bit for bit, and two launches bit-equal) and on
    the edge case; per launch times of K6, its plain version and
    ``repeat_interleave`` (CUDA events), and the bytes bound. Returns the
    kernels-line row: the garden workload's numbers, both workloads'
    under "workloads"."""
    edge_domain = 1 << 15
    starts, fields = exp_decode_proto.edge_case(edge_domain, K6_F, n=5000)
    args = (starts, decode_runs.diffs_from_fields(fields), edge_domain, K6_F)
    got = decode_runs.decode_runs(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, decode_runs.decode_runs_reference(*args))
          and torch.equal(got, binning._expand_runs(fields, starts,
                                                    edge_domain)),
          "K6 differs from its plain version on the edge case")
    print(f"k6 edge case: {starts.shape[0]} runs over {edge_domain} slots "
          f"(first start {int(starts[0])}, "
          f"{int((starts[1:] == starts[:-1]).sum())} repeated starts, "
          f"{int((starts >= edge_domain).sum())} at or past the domain, "
          "fields over the whole int32 range): equal to its plain version "
          "and _expand_runs")

    per = []
    for name, (n, domain) in K6_WORKLOADS.items():
        starts, fields = exp_decode_proto.make_case(n, domain, K6_F)
        args = (starts, decode_runs.diffs_from_fields(fields), domain, K6_F)
        got = decode_runs.decode_runs(*args)
        again = decode_runs.decode_runs(*args)
        torch.cuda.synchronize()
        plain = decode_runs.decode_runs_reference(*args)
        expand = binning._expand_runs(fields, starts, domain)
        err = (got.long() - plain.long()).abs().max().item()
        check(torch.equal(got, again), f"two K6 launches differ ({name})")
        check(torch.equal(got, plain),
              f"K6 differs from its plain version ({name}): max|d| {err}")
        check(torch.equal(got, expand), f"K6 differs from _expand_runs "
              f"({name})")
        rows, lengths = exp_decode_proto.repeat_inputs(starts, fields, domain)

        def library():
            return torch.repeat_interleave(rows, lengths, dim=0,
                                           output_size=domain)

        check(torch.equal(library(), expand),
              f"repeat_interleave differs from _expand_runs ({name})")

        def kernel():
            return decode_runs.decode_runs(*args)

        ms = device_ms(kernel, reps=50)
        plain_ms = cuda_ms(lambda: decode_runs.decode_runs_reference(*args),
                           reps=5)
        library_ms = device_ms(library, reps=50)
        dispatch_ms = cuda_ms(kernel, reps=50, warmup=3)
        library_dispatch_ms = cuda_ms(library, reps=50, warmup=3)
        t_bytes, t_ops = k6_bound(starts, domain)
        print(f"k6 {name}: {n} runs ({int((starts[1:] == starts[:-1]).sum())}"
              f" zero-length) over {domain} slots, f {K6_F}: bit-equal to its "
              "plain version and _expand_runs, two launches bit-equal; "
              f"device time per call (profiler, 50 calls) K6 {ms:.4f} ms, "
              f"repeat_interleave {library_ms:.4f} ms; back-to-back calls "
              f"(CUDA events) K6 {dispatch_ms:.4f} ms, repeat_interleave "
              f"{library_dispatch_ms:.4f} ms, plain version {plain_ms:.4f} "
              f"ms; bound {t_bytes:.4f} ms by bytes ({t_ops:.4f} ms by "
              "operations)")
        per.append({"workload": name, "runs": n, "slots": domain,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "dispatch_ms": dispatch_ms,
                    "library_dispatch_ms": library_dispatch_ms,
                    "bound_ms": max(t_bytes, t_ops), "max_abs_err": err})
    row = kernel_row("decode_runs", "decode_runs.cu", decode_runs.REPLACES,
                     err, ms, dispatch_ms, plain_ms, t_bytes, t_ops,
                     library_ms)
    row["library_dispatch_ms"] = library_dispatch_ms
    row["workloads"] = per
    row["host_us"], row["chained_800p_ms"] = k6_host_and_chain()
    return row


def host_us(fn) -> float:
    """Host time of one ``fn`` call in microseconds: the median over
    HOST_ROUNDS of HOST_REPS back-to-back calls (host clock; the card is
    synchronised between rounds, and a round's launches fit the queue)."""
    times = []
    for _ in range(HOST_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            fn()
        times.append((time.perf_counter() - t0) / HOST_REPS * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def k6_host_and_chain():
    """K6's wrapper at the decode tool's 800p workload: its host cost part
    by part (the checks, the status buffer and the output allocation, the
    device and stream lookup, the ctypes call into the library, refused
    there before any launch, and the whole call), beside one
    ``repeat_interleave`` call's; then K6 and ``repeat_interleave`` chained
    in alternating turns. Returns ({part: us}, {name: [ms per turn]})."""
    n, domain = K6_WORKLOADS["800p"]
    starts, fields = exp_decode_proto.make_case(n, domain, K6_F)
    diffs = decode_runs.diffs_from_fields(fields)
    args = (starts, diffs, domain, K6_F)
    rows, lengths = exp_decode_proto.repeat_inputs(starts, fields, domain)
    dev = starts.device
    slots = decode_runs.slots_per_block(K6_F)
    stream = _build.current_stream(dev)
    fn, _ = _build._entry("decode_runs", decode_runs._ARGS)

    def kernel():
        return decode_runs.decode_runs(*args)

    def library():
        return torch.repeat_interleave(rows, lengths, dim=0,
                                       output_size=domain)

    kernel()
    torch.cuda.synchronize()
    parts = {
        "checks": lambda: (decode_runs._check_inputs(*args),
                           dev.type == "cpu", dev.type != "cuda",
                           starts.is_contiguous() and diffs.is_contiguous()),
        "allocation": lambda: (
            decode_runs._state(dev, stream, 1 + domain // slots * K6_F),
            torch.empty((domain, K6_F), dtype=torch.int32, device=dev)),
        "device and stream": lambda: (
            dev.index == torch.cuda.current_device(),
            _build.current_stream(dev)),
        "ctypes": lambda: fn(starts.data_ptr(), diffs.data_ptr(), n,
                             diffs.shape[1], domain, 0, slots, 0, 0, 1,
                             stream),
        "whole call": kernel,
        "repeat_interleave call": library}
    cost = {name: host_us(part) for name, part in parts.items()}

    def chained(fn):
        def make_body():
            def body(acc, _eps):
                return acc + fn()[-1, 0].float() * 1e-30
            return body
        return chain_bench.chain(make_body, torch.zeros((), device=dev),
                                 iters=CHAIN_ITERS, reps=CHAIN_REPS)

    turns = {"K6": [], "repeat_interleave": []}
    for _ in range(CHAIN_TURNS):
        turns["K6"].append(chained(kernel))
        turns["repeat_interleave"].append(chained(library))
    print("k6 host cost per 800p call (host clock, median of "
          f"{HOST_ROUNDS} x {HOST_REPS} calls): " + ", ".join(
              f"{k} {v:.2f} us" for k, v in cost.items())
          + " (ctypes: the library's entry refusing f = 0 before any "
          "launch)")
    print(f"k6 chained at 800p ({CHAIN_TURNS} alternating turns of "
          f"{CHAIN_ITERS} steps, best of {CHAIN_REPS}; ms per step): "
          + "; ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                      for k, v in turns.items())
          + f"; medians K6 {statistics.median(turns['K6']):.4f}, "
          f"repeat_interleave "
          f"{statistics.median(turns['repeat_interleave']):.4f}")
    return cost, turns


def phase_k7():
    """Each K7 probe vs its plain version, exactly, on the tool's arange
    input and a seeded input with |x| < 2^20 and a negative x[0, 0]; per
    launch times (CUDA events). Returns the kernels-line row: the slowest
    probe's numbers, every probe's under "probes"."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rand = (torch.rand((16, 128), generator=gen, device="cuda") * 2 - 1) \
        * 2 ** 20
    rand[0, 0] = -300.75
    arange = torch.arange(16 * 128, dtype=torch.float32,
                          device="cuda").reshape(16, 128)
    probes, worst = [], 0.0
    for name, (kernel, plain) in K7_PROBES.items():
        for label, x in (("arange", arange), ("random", rand)):
            got = kernel(x)
            torch.cuda.synchronize()
            want = plain(x)
            err = (got - want).abs().max().item()
            check(torch.equal(got, want), f"K7 probe {name} differs from its "
                  f"plain version on the {label} input: max|d| {err}")
            worst = max(worst, err)
        if name == "p6_transpose":
            ms, library_ms = k7_transpose_turns(kernel, arange)
        else:
            ms, library_ms = device_ms(lambda: kernel(arange), reps=50), None
        plain_ms = cuda_ms(lambda: plain(arange), reps=5)
        dispatch_ms = cuda_ms(lambda: kernel(arange), reps=200, warmup=5)
        t_bytes = (arange.numel() + got.numel()) * 4 / HBM_BYTES_PER_S * 1e3
        probes.append({"name": name,
                       "replaces": exp_mosaic_probe.REPLACES[name],
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bytes,
                       "library_ms": library_ms, "dispatch_ms": dispatch_ms})
    print("k7: 10 probes equal to their plain versions on arange and a "
          "seeded input; device time per launch (profiler, 50 launches) / "
          "back-to-back launches (CUDA events, 200) in ms: " + ", ".join(
              f"{p['name']} {p['ms']:.4f} / {p['dispatch_ms']:.4f}"
              for p in probes))
    slowest = max(probes, key=lambda p: p["ms"])
    row = kernel_row("mosaic_probe", "mosaic_probe.cu", slowest["replaces"],
                     worst, slowest["ms"], slowest["dispatch_ms"],
                     slowest["plain_ms"], slowest["bound_ms"], 0.0,
                     slowest["library_ms"])
    row["probes"] = probes
    return row


def k7_transpose_turns(kernel, x):
    """``p6_transpose`` and ``x.t().contiguous()``, device time per launch
    in K7_TURNS alternating turns of 50 launches; prints both medians and
    spreads (max - min) and returns the two medians."""
    turns = {"p6_transpose": [], "x.t().contiguous()": []}
    for _ in range(K7_TURNS):
        turns["p6_transpose"].append(device_ms(lambda: kernel(x), reps=50))
        turns["x.t().contiguous()"].append(
            device_ms(lambda: x.t().contiguous(), reps=50))
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"k7 p6_transpose vs x.t().contiguous() ({K7_TURNS} alternating "
          "turns, device ms per launch): " + "; ".join(
              f"{k} " + " / ".join(f"{t:.7f}" for t in v)
              + f" (median {med[k]:.7f}, spread {max(v) - min(v):.7f})"
              for k, v in turns.items()))
    return med["p6_transpose"], med["x.t().contiguous()"]


def phase_tools():
    """The port's three tools as a user runs them: the decode tool at both
    workloads (K6), the probe tool (K7, ten launches), every chain_bench
    configuration once (each through its blend or z-buffer kernel once per
    chained step). Returns K6's and K7's launches in their tools and the
    decode tool's results (chained ms per call of K6, the plain expansion
    and repeat_interleave, per workload)."""
    reset_launch_counts()
    decoded = exp_decode_proto.main([])
    k6 = decode_runs.launches
    check(k6 == K6_TOOL_LAUNCHES,
          f"the decode tool launched K6 {k6} times, not {K6_TOOL_LAUNCHES}")
    reset_launch_counts()
    exp_mosaic_probe.main([])
    k7 = exp_mosaic_probe.launches
    check(k7 == len(K7_PROBES), f"the probe tool launched {k7} probes")
    print(f"tools: the decode tool launched K6 {k6} times, the probe tool "
          f"{k7} probes")

    for which, kernels in CHAIN_KERNELS.items():
        torch.cuda.synchronize()
        reset_launch_counts()
        ms = chain_bench.run(which)
        torch.cuda.synchronize()
        counts = {**launch_counts(), "K3": zbuffer_pallas.launches}
        steps = (chain_bench.REPS + 1) * (chain_bench.iters_for(which) + 1)
        want = {k: steps if k in kernels else 0 for k in counts}
        check(counts == want, f"chain_bench {which} launched {counts}, "
              f"expected {want}")
        check(math.isfinite(ms) and ms > 0, f"chain_bench {which}: {ms} ms")
        print(f"chain_bench {which}: {steps} steps launched "
              + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return k6, k7, decoded


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's kernels run "
             "only on an NVIDIA GPU")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_build()
    params, state, _ = demo.demo_scene(n=N, w=W, h=H, sh_degree=SH_DEGREE)
    rows = {"K1": phase_k1_parity(params, state),
            "K2": phase_k2_parity(params, state)}
    phase_small_reference()
    loaded, lstate = phase_serve(params, state)
    phase_breakdown(loaded, lstate)
    phase_train(loaded, lstate, rows)
    phase_trainer()
    phase_scene(rows)

    pallas = phase_pallas_serve(params, state)
    pallas_32, _ = sized_settings(PALLAS_PROBE_32, params, state.alive,
                                  demo.demo_camera(W, H))
    rows.update(phase_k4_k5_parity(params, state, pallas, pallas_32))
    rows["K4"]["launches"], rows["K5"]["launches"] = phase_pallas_train(
        params, state)
    garden = phase_garden()
    for name in ("K1", "K2", "K4", "K5"):
        rows[name]["garden"] = garden[name]

    nparams, nstate = neural_scene()
    rows["K3"] = phase_k3_parity(nparams, nstate)
    phase_small_neural_reference()
    phase_neural_serve(nparams, nstate)
    rows["K3"]["launches"] = phase_neural_train(nparams, nstate)
    del nparams, nstate

    rows["K6"] = phase_k6()
    rows["K7"] = phase_k7()
    rows["K6"]["launches"], rows["K7"]["launches"], decoded = phase_tools()
    # the decode tool's chained times beside the phase's per-launch ones
    for entry, result in zip(rows["K6"]["workloads"], decoded):
        check(entry["workload"] == result["name"], "decode tool workloads")
        entry.update(chained_ms=result["k6_ms"],
                     chained_plain_ms=result["plain_ms"],
                     chained_library_ms=result["repeat_interleave_ms"])

    print(json.dumps({"kernels": [rows[k] for k in sorted(rows)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
