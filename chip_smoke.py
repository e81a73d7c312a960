"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from csrc/ (K1, the 32x32 tile blend;
K2, its backward; K3, the neural path's z-buffer; K4, the blend at any tile
shape, 16x16 on the pallas path; K5, its backward; K6, the run-length
decode; K7, the idiom probes; and the port's own pairs, forward and
backward, of preprocess and of the neural path's denoiser), holds each
against its plain PyTorch version at the shapes of its workload, then
drives the paths as a user would.

Preprocess (first): both kernels against the plain version and its
float64 run at the benchmark's garden size (5M Gaussians, 1297x840, SH 3)
and at 800x800/100k, each timed per call beside the plain version and its
bytes bound; every later phase goes through them. Then Adam: the kernel
over garden's seven groups (615M floats) bit-equal to the plain version,
timed beside it and its bytes bound. Then the denoiser's pair at 800x800
on the map as the CNN writes it: the forward bit-equal to the plain
version, both gradients within 1e-5 of their scale, each timed beside the
plain version and its bytes bound. Then the binning kernels at the garden
cells' call (that cloud, 32x32 tiles, precise cull, the exact key) and at
the neural z-buffer's (300k, the packed key): ``Instances`` bit-equal to
the plain version, the kernels and the sort alone each timed beside the
plain version and its bytes bound, with a per-kernel split.

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
copy trains 100 iterations at -r 2. Then the offline phase on those files:
``python -m neuralgaussiansplatting_torch.render``'s ``main`` renders the
saved model's 30 views (K1 once per view; the 6 test views again under
``--backend pallas``, K4 once per view, no drops; both with the buffers
its warning asks for on this model), ``.metrics``' ``main``
scores them (SSIM, PSNR within 0.5 dB of the run's, LPIPS from seeded
synthetic VGG weights), and ``.trainn``'s ``main`` trains the sw=2 neural
path 300 iterations from the halfway checkpoint (K3 at least once per
iteration, test PSNR up by 1 dB, 60 video frames and 2 archives, the
feature statistics, the saved geometry bit-equal to the checkpoint's).

Neural path (800x800, 100k Gaussians, SH degree 1, seeded 64-d features,
full-width decoders): the tiled z-buffer against the per-pixel sort oracle;
a 64x64 card-vs-CPU reference; ``render1/2/3`` from four cameras; 10 steps
of ``train.neural_loop.NeuralTrainer(sw=2)``.

Multi-step, parallel and viewer paths: ``Trainer.step_block`` (5 blocks of
4) bit-equal to 20 ``Trainer.step``s at the bench width; on a world of one
NCCL rank (a ``file://`` store), ``DPTrainer`` with a batch of 4 (one
step's densification statistics against 4 single-camera iterations, then
10 steps) and the 800x800 frame in 5 strips through
``parallel.render_sp.make_sharded_renderer`` against the monolithic
render; the train entry point with ``--steps_per_call 10`` over the scene
phase's dataset (its saved PLY bit-equal to the ``--steps_per_call 1``
run's) and serving the SIBR viewer protocol to a client thread (two
800x800 frames byte-equal to direct renders); and two ``NeuralTrainer(sw=2)``
runs that must repeat to the bit (5 steps on one view, 100 over eight).

Tools: K6 against its plain version and ``binning._expand_runs`` at the
decode tool's two workloads (100k runs over 655,360 slots; 5M over
8,388,608) and on an edge case, K7's ten probes against theirs, each
then timed against its one-call PyTorch counterpart and an empty kernel
(the launch floor) in alternating turns; then the port's
``tools.exp_decode_proto`` and ``tools.exp_mosaic_probe`` mains and every
``tools.chain_bench`` configuration once.

Bench (the JAX package's bench and stage-timing tools, ported, at full
width with the JAX tools' chained depths): ``tools.bench_garden`` on the
garden phase's 5M cloud in its dense, ``--seqscatter`` and ``--scatter``
modes (drops only what the settings' caps clip: the dense cap, and
``--scatter``'s 4096 per 32x32 tile); then
``bench``, ``tools.bench_suite`` (its four workloads, the 1080p probe
without drops) and the four ``tools.exp_*_micro`` stage timers, every row.
Each tool's launches are held to its chained steps; each chain is followed
by one checked step (finite output), under the profiler beside the bench
workloads.

Quality (the JAX package's full-schedule harnesses, ported to
``neuralgaussiansplatting_torch/tools/``, at full width with the depth
cut): ``train_quality_proof``'s 800x800 scene (100 train and 25 test
views, 40k GT Gaussians, a 10k init cloud) trained 3000 iterations (test
PSNR at 1000 and 3000 no more than 1 dB below the JAX package's published
rows, the capacity grown, no drops at the tune points, K1 once per
iteration and evaluation render, K2 once per iteration); the oracle's
``hold`` 200 iterations on it (44 dB or more); ``train_neural_quality``
300 iterations of ``--sw 2`` from its PLY (test PSNR finite and rising,
K3 at least once per iteration); ``train_garden``'s 1920x1080 scene (40
views, 300k GT, 1M init points) trained 500 iterations (test PSNR at 500
no more than 1 dB below the published row, finite losses); and
``bench_trained_scene`` on the proof's model (no drops in its probe).

Each path checks that it went through its kernels. It prints one JSON line
of per-kernel numbers, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line. Needs a CUDA device and nvcc (CUDA_HOME or
/usr/local/cuda); imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import statistics
import socket
import subprocess
import sys
import struct
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch import native
from neuralgaussiansplatting_torch import metrics as metrics_entry
from neuralgaussiansplatting_torch import render as render_entry
from neuralgaussiansplatting_torch import trainn as trainn_entry
from neuralgaussiansplatting_torch import gaussian_renderer as gr
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.models import nets
from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import blend
from neuralgaussiansplatting_torch.ops import blend_pallas
from neuralgaussiansplatting_torch.ops import blend_seq
from neuralgaussiansplatting_torch.ops import decode_runs
from neuralgaussiansplatting_torch.ops import denoise as denoise_ops
from neuralgaussiansplatting_torch.ops import idxmap as idxmap_ops
from neuralgaussiansplatting_torch.ops import knn
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops import zbuffer_pallas
from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.parallel import distributed
from neuralgaussiansplatting_torch.parallel import mesh as mesh_lib
from neuralgaussiansplatting_torch.parallel.render_sp import (
    make_sharded_renderer, strip_cameras)
from neuralgaussiansplatting_torch.parallel.train_step import (
    DPTrainer, make_dp_train_step, stack_cameras)
from neuralgaussiansplatting_torch.scene import colmap as colmap_io
from neuralgaussiansplatting_torch.scene import image_io
from neuralgaussiansplatting_torch.scene import ply as ply_io
from neuralgaussiansplatting_torch import bench
from neuralgaussiansplatting_torch.tools import _micro
from neuralgaussiansplatting_torch.tools import bench_garden
from neuralgaussiansplatting_torch.tools import bench_suite
from neuralgaussiansplatting_torch.tools import bench_trained_scene
from neuralgaussiansplatting_torch.tools import chain_bench
from neuralgaussiansplatting_torch.tools import exp_binning_micro
from neuralgaussiansplatting_torch.tools import exp_bwd_micro
from neuralgaussiansplatting_torch.tools import exp_neural_micro
from neuralgaussiansplatting_torch.tools import exp_stage_micro
from neuralgaussiansplatting_torch.tools import exp_quality_oracle
from neuralgaussiansplatting_torch.tools import exp_decode_proto
from neuralgaussiansplatting_torch.tools import exp_mosaic_probe
from neuralgaussiansplatting_torch.tools import make_demo_scene
from neuralgaussiansplatting_torch.tools import train_garden
from neuralgaussiansplatting_torch.tools import train_neural_quality
from neuralgaussiansplatting_torch.tools import train_quality_proof
from neuralgaussiansplatting_torch.train import __main__ as train_entry
from neuralgaussiansplatting_torch.train import densify as dens
from neuralgaussiansplatting_torch.train import loop
from neuralgaussiansplatting_torch.train import neural_loop
from neuralgaussiansplatting_torch.train import optim
from neuralgaussiansplatting_torch.utils import losses
from neuralgaussiansplatting_torch.utils import lpips
from neuralgaussiansplatting_torch.utils import timing
from neuralgaussiansplatting_torch.utils.timing import (cuda_ms, device_ms,
                                                        device_records,
                                                        parts_ms,
                                                        profiled)
from neuralgaussiansplatting_torch.viewer import network_gui

# the preprocess kernels' edge rows and tolerance gate, shared with their
# card tests (tests/preprocess_cases.py imports no JAX)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
import preprocess_cases as cases  # noqa: E402

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
# whose alpha is 0; ``blend.blend_pair_counts`` counts them). The power
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
# The offline phase works on the scene phase's files: the render entry
# point renders the saved model (the resume's, at SCENE_ITERS) from its 24
# train and 6 test views, K1 once per view, and again the test views under
# --backend pallas (K4 once per view); the metrics entry point scores the
# test renders with seeded synthetic LPIPS weights (the VGG weights are not
# in the repository), its PSNR within OFFLINE_PSNR_GATE dB of the run's own
# (the PNGs' uint8 rounding); the neural entry point trains the sw=2 path
# TRAINN_ITERS iterations from the halfway checkpoint, video frames and
# feature statistics included.
# The render entry point's defaults (train.py's pipeline flags: capacity
# 2^20, max_per_tile 4096) drop instances on this model: its densest 32x32
# tile holds more than 4096 instances, and a 16x16 view more than 2^20
# (the render lines print both demands). So it is given the buffers a user
# who reads its warning gives it.
OFFLINE_VIEWS = {"train": 24, "test": 6}
RENDER_ARGS = ["--max_per_tile", "8192"]
PALLAS_RENDER_ARGS = ["--backend", "pallas", "--skip_train", "--capacity",
                      str(1 << 21), "--max_per_tile", "8192"]
OFFLINE_PSNR_GATE = 0.5
TRAINN_ITERS, TRAINN_ANALYSIS, TRAINN_PSNR_GAIN = 300, 150, 1.0
VIDEO_FRAMES = 60                  # the demo tool's orbit
VIDEO_ARCHIVES = 2                 # frames 0 and 36, every 36th
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
# K7: each probe against its one-call PyTorch counterpart
# (exp_mosaic_probe.COUNTERPARTS) and the library's empty kernel, the
# launch floor, in K7_TURNS alternating turns; a turn times K7_REPS
# launches of each in one profiler window (device time per launch) and
# K7_DISPATCH_REPS back-to-back launches of each (CUDA events). The
# targets: p6_transpose at or below x.t().contiguous(), every probe within
# K7_FLOOR_GAP_MS of the floor, each probe's back-to-back time within
# K7_DISPATCH_RATIO times its counterpart's. A probe that misses one is
# reported, not failed.
K7_TURNS, K7_REPS, K7_DISPATCH_REPS = 7, 50, 200
K7_FLOOR_GAP_MS, K7_DISPATCH_RATIO = 0.0005, 2.0
# the probes' and the floor's kernel names (csrc/mosaic_probe.cu's
# namespace k7), demangled or not
K7_KERNEL = re.compile(r"\bk7::|_ZN2k7")
K7_PROBES = exp_mosaic_probe.PROBES
# The launches each part of a k7 window makes per call: the probe's and
# the floor's one, and each counterpart's as the profiler reads it with
# every record kept: one, but torch.dot's two. Late in this run the
# profiler keeps as few as 23 of a kernel's 50 records in a window, so a
# window is read when each part shows these launches and each kernel
# kept K7_LEAST_KEPT of its records, the base of its mean record time.
K7_LIBRARY_LAUNCHES = {"p5_smem_2d": 2}
K7_LEAST_KEPT = 0.2
# K7's bound by bytes: each probe writes its output once and reads once the
# elements of x (16, 128) float32 that its function needs, not those its
# idiom copies (p3's bulk copy moves row 0 for x[0, 5]); its few float adds
# are nothing beside that. name -> number of elements of x read.
K7_READS = {
    "p1_roll_11_bcast": lambda x: 1,                      # x[0, 3]
    "p1b_dynroll": lambda x: len(                         # x[0, 0], x[0, k]
        {0, exp_mosaic_probe._floor_mod_lane(x)}),
    "p2_twostep": lambda x: 4,                            # x[0, :4]
    "p6_transpose": lambda x: x.numel(),
    **{f"p3_smem_{kb}kb": lambda x: 1 for kb in (2, 4, 8, 16)},  # x[0, 5]
    "p4_smem_loop": lambda x: 128,                        # x[0]
    "p5_smem_2d": lambda x: 256,                          # x[0], x[1]
}
# the blend and z-buffer kernels each configuration of tools.chain_bench
# launches once per step
CHAIN_KERNELS = {"classic_fb": ("K4", "K5"), "classic_fb_seq": ("K1", "K2"),
                 "classic_fwd_seq": ("K1",), "classic_fwd1080_seq": ("K1",),
                 "classic_fwd1080": ("K4",), "neural_fb": ("K3",),
                 "neural_fb_bf16": ("K3",)}
# The multi-step dispatch: Trainer.step_block over MULTISTEP_BLOCKS blocks
# of MULTISTEP_BLOCK iterations against as many Trainer.steps at the bench
# width; the train entry point with --steps_per_call MULTISTEP_SPC (a
# divisor of the scene phase's densification and tune intervals, 100).
MULTISTEP_BLOCKS, MULTISTEP_BLOCK, MULTISTEP_SPC = 5, 4, 10
# Data and strip parallelism on a world of one NCCL rank: DPTrainer with a
# batch of DP_BATCH orbit cameras for DP_STEPS steps; the 800x800 frame in
# SP_STRIPS strips of 160 rows (five 32-row tile rows each).
DP_BATCH, DP_STEPS, SP_STRIPS = 4, 10, 5
SP_ATOL = 1e-5    # tests/test_parallel.py:49, held at 48x64
SP_ULPS = 8       # a strip's pixel rows against the frame's, in ulps of H
# The viewer: the train entry point resumed from the scene phase's
# checkpoint serves two frames, then trains VIEWER_ITERS iterations.
VIEWER_ITERS = 30
# Neural repeatability: NeuralTrainer(sw=2) runs of NEURAL_REPEAT_SHORT
# steps on one view and of NEURAL_REPEAT_LONG steps over eight (the length
# at which two runs with cuDNN's default algorithms and F.pad's reflect
# padding were seen to part).
NEURAL_REPEAT_SHORT, NEURAL_REPEAT_LONG = 5, 100
# The bench phase: the JAX package's bench and stage-timing tools as the
# port runs them (bench, tools.bench_suite, tools.bench_garden on the
# garden phase's cloud in BENCH_GARDEN_MODES, the four exp_*_micro tools),
# at full width with the JAX tools' chained depths. Each chain a tool runs
# is followed by one more step of its body from its first carry, whose
# output must be finite; beside the bench workloads that step runs under
# the profiler (its device-busy share). A chain of ``iters`` steps, best of
# ``reps``, therefore launches each of its kernels chain_launches(iters,
# reps) times.
BENCH_GARDEN_MODES = ("dense", "seqscatter", "scatter")
# The quality phase: the JAX package's full-schedule harnesses, ported to
# neuralgaussiansplatting_torch/tools/, at their full width (the proof's
# 800x800 scene of 100 train and 25 test views, 40k GT Gaussians and a 10k
# init cloud; the garden's 1920x1080 scene of 40 train views, 300k GT and a
# 1M init cloud) and at a cut depth. Its gates: test PSNR no more than
# QUALITY_MARGIN dB below the JAX package's published rows
# (docs/DESIGN.md:158-161, 177-179), the oracle's hold at the GT-recovery
# level the JAX package reports (docs/DESIGN.md:206-207).
QUALITY_ITERS, ORACLE_ITERS = 3000, 200
NEURAL_QUALITY_ITERS, GARDEN_ITERS = 300, 500
QUALITY_MARGIN = 1.0
QUALITY_PUBLISHED = {1000: 31.8, 3000: 35.8}
GARDEN_PUBLISHED = {500: 21.27}
ORACLE_PSNR = 44.0


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


def k1_inputs(params, state, cam, settings=SETTINGS):
    """Preprocess -> bin -> pack as ``rasterize`` runs them for one view:
    the inputs the blend kernel of ``settings`` sees on the main path (K1's
    for the seq settings, K4's for the pallas ones)."""
    tiles_x, tiles_y = settings.tiles_for(cam.width, cam.height)
    pre = pp.preprocess_gaussians(
        params.xyz, gm.get_scaling(params), gm.get_rotation(params),
        gm.get_opacity(params, state.alive), gm.get_features(params),
        SH_DEGREE, cam, settings.block_x, settings.block_y,
        tight=settings.tight_culling)
    inst = binning.bin_gaussians(
        pre, tiles_x, tiles_y, settings.capacity, settings.max_per_tile,
        settings.chunk, pack_keys=settings.fast_sort,
        packed_capacity=settings.packed_capacity,
        precise_cull=settings.precise_cull, block_x=settings.block_x,
        block_y=settings.block_y, width=cam.width, height=cam.height)
    packed = blend.pack_gather(blend.pack_instance_attrs_t(
        pre.means2d, pre.conic, pre.opacity, pre.rgb), inst.gid)
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
    logs = _build.build(["blend_seq_fwd", "blend_seq_bwd", "blend_stage",
                         "zbuffer_fwd", "blend_pallas_fwd",
                         "blend_pallas_bwd", "decode_runs", "mosaic_probe",
                         "preprocess_fwd", "preprocess_bwd",
                         "adam_update", "denoise_fwd", "denoise_bwd",
                         "binning"])
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


# The preprocess kernels' workloads: (Gaussians, width, height). "garden" is
# the benchmark's garden840 cells (5M Gaussians at 1297x840, SH 3), its
# cloud drawn on the card from a seed in front of the demo camera; "800p" is
# the classic path's demo cloud, its quaternions and a per-axis stretch of
# its scales drawn from a seed.
PRE_WORKLOADS = {"garden": (5_000_000, 1297, 840), "800p": (N, W, H)}


def preprocess_bytes(n: int, deg: int, offset: bool) -> tuple[int, int]:
    """(forward, backward) bytes of the preprocess pass as the function
    needs them, each input read once and each output written once. Forward:
    xyz 3, scale 3, rotation 4, opacity 1, SH 3 (deg + 1)^2 (and the offset
    2) read; means2d 2, depth 1, radius 1, conic 3, rgb 3, the rects 4,
    tiles 1 written. Backward: the same inputs but the opacity, and the
    gradients of means2d 2, conic 3, rgb 3, read; the gradients of xyz,
    scale, rotation, SH (and offset) written."""
    k = 3 * (deg + 1) ** 2
    off = 2 if offset else 0
    fwd = (3 + 3 + 4 + 1 + k + off) + (2 + 1 + 1 + 3 + 3 + 4 + 1)
    bwd = (3 + 3 + 4 + k + 2 + 3 + 3) + (3 + 3 + 4 + k + off)
    return 4 * n * fwd, 4 * n * bwd


# the colour variant (precomputed colours, as Scaffold-GS renders): garden's
# 5M Gaussians and scaffold840's 8M candidates, at 1297x840
COLOR_WORKLOADS = (5_000_000, 8_000_000)


def preprocess_colors(n: int) -> tuple[dict, dict]:
    """The preprocess kernels' colour variant on ``n`` garden-drawn
    Gaussians at 1297x840 (32x32 tiles, tight, no offset), held to the
    plain version with the same precomputed colours under
    ``phase_preprocess``' gate (``preprocess_cases.assert_held``): means2d,
    depths and conic to each row's scale, and the means', scales' and
    rotations' gradients to the largest |gradient| of their band, each as
    close to the float64 plain version as the float32 one is, or within
    1e-5; the integer outputs equal but on at most 1e-5 of the rows.
    Besides: every geometric output the SH variant's bits, the colours the
    rgb output itself and their gradient the upstream one, two backward
    launches bit-equal, one launch each way. Then the device time
    (profiler, 20 calls), back-to-back time (CUDA events), the plain
    version's and the bytes bound of each way (forward 23 floats a
    Gaussian, backward 25: no SH and no colour read or written). Returns
    the (forward, backward) workload entries."""
    w, h = 1297, 840
    inputs, cam = garden_preprocess_inputs(n, w, h, seed=7)
    del inputs["offset"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    inputs["colors"] = torch.rand((n, 3), device="cuda", generator=gen)
    groups = ["bulk"] * n
    leaves = ("means3d", "scales", "rotations", "colors")

    def make(dtype=torch.float32):
        ins = {k: v.detach().to(dtype, copy=True) for k, v in
               inputs.items()}
        for k in leaves:
            ins[k].requires_grad_()
        c = cam
        if dtype != torch.float32:
            c = copy.copy(cam)
            for k in ("view", "full_proj", "campos"):
                setattr(c, k, getattr(cam, k).to(dtype))
        return ins, c

    def call(fn, made, colored=True, grad=True):
        ins, c = made
        with torch.set_grad_enabled(grad):
            return fn(ins["means3d"], ins["scales"], ins["rotations"],
                      ins["opacities"], ins["shs"], SH_DEGREE, c, 32, 32,
                      tight=True,
                      colors_precomp=ins["colors"] if colored else None)

    def held(label, *args):
        try:
            return cases.assert_held(label, *args)
        except AssertionError as e:
            fail(f"preprocess colour variant {label} ({n}): further from "
                 f"the float64 plain version than the float32 one, in rows "
                 f"{e}")

    plain = pp.preprocess_gaussians_reference
    mk, mp, mr = make(), make(), make(torch.float64)
    sh = call(pp.preprocess_gaussians, mk, colored=False, grad=False)
    f0, b0 = pp.launches, pp.bwd_launches
    got = call(pp.preprocess_gaussians, mk)
    want, ref = call(plain, mp), call(plain, mr)
    check(all(torch.equal(getattr(got, f), getattr(sh, f)) for f in (
        "means2d", "depths", "radii", "conic", "rect_min", "rect_max",
        "tiles_touched")) and got.rgb is mk[0]["colors"],
          f"preprocess colour variant ({n}): its geometry is not the SH "
          "variant's bits, or the colours do not pass through")
    del sh
    err = 0.0
    for field in ("means2d", "depths", "conic"):
        r = getattr(ref, field).detach()
        err = max(err, held(f"forward {field}", getattr(got, field),
                            getattr(want, field), r, groups,
                            cases.row_scale(field, r, cam)))
    differ = torch.zeros(n, dtype=torch.bool, device="cuda")
    for field in ("radii", "rect_min", "rect_max", "tiles_touched"):
        differ |= (getattr(got, field) != getattr(want, field)).reshape(
            n, -1).any(dim=1)
    check(int(differ.sum()) <= 1e-5 * n, f"preprocess colour variant "
          f"({n}): {int(differ.sum())} rows differ in an integer output")
    live = (want.radii > 0)[:, None]
    cot = [torch.where(live, torch.randn((n, c), device="cuda",
                                         generator=gen) * sc, 0.0)
           for c, sc in ((2, 1e-2), (3, 1e-1), (3, 1.0))]
    outs = [got.means2d, got.conic, got.rgb]
    outs_p = [want.means2d, want.conic, want.rgb]
    wrt = [mk[0][k] for k in leaves]
    wrt_p = [mp[0][k] for k in leaves]
    gk = torch.autograd.grad(outs, wrt, cot, retain_graph=True)
    again = torch.autograd.grad(outs, wrt, cot, retain_graph=True)
    check((pp.launches - f0, pp.bwd_launches - b0) == (1, 2),
          f"preprocess colour variant ({n}): launches "
          f"{(pp.launches - f0, pp.bwd_launches - b0)}, not (1, 2)")
    check(all(torch.equal(a, b) for a, b in zip(gk, again))
          and torch.equal(gk[3], cot[2]), f"preprocess colour variant "
          f"({n}): two backward launches differ, or the colours' gradient "
          "is not the upstream one")
    gp = torch.autograd.grad(outs_p, wrt_p, cot, retain_graph=True)
    gr = torch.autograd.grad([ref.means2d, ref.conic, ref.rgb],
                             [mr[0][k] for k in leaves],
                             [c.double() for c in cot])
    del ref, mr
    gerr = 0.0
    for leaf, a, c, r in zip(leaves[:3], gk, gp, gr):
        gerr = max(gerr, held(f"backward {leaf}", a, c, r,
                              cases.magnitude_bands(groups, r)))
    del gk, again, gp, gr

    def bwd(fn_outs, fn_wrt):
        return lambda: torch.autograd.grad(fn_outs, fn_wrt, cot,
                                           retain_graph=True)

    out = []
    for kernel, fn, plain_fn, floats, e in (
            ("preprocess_fwd", lambda: call(pp.preprocess_gaussians, mk,
                                            grad=False),
             lambda: call(plain, mp, grad=False), 23, err),
            ("preprocess_bwd", bwd(outs, wrt), bwd(outs_p, wrt_p), 25,
             gerr)):
        ms = device_ms(fn, reps=20)
        dispatch_ms = cuda_ms(fn, reps=20, warmup=2)
        plain_ms = cuda_ms(plain_fn, reps=3)
        bound_ms = 4 * floats * n / HBM_BYTES_PER_S * 1e3
        print(f"{kernel} colours {n}: {n} Gaussians at {w}x{h}, precomputed "
              f"colours, tight: device time per call (profiler, 20 calls) "
              f"{ms:.4f} ms, back-to-back calls (CUDA events) "
              f"{dispatch_ms:.4f} ms, plain version {plain_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms by bytes ({4 * floats * n} B), "
              f"{100 * bound_ms / ms:.1f} % of it; largest error from the "
              f"float64 plain version {e:.3e} of its scale (each row's, or "
              "its band's largest)")
        out.append({"workload": f"colors {n}", "gaussians": n, "width": w,
                    "height": h, "ms": ms, "dispatch_ms": dispatch_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "max_rel_err": e})
    del got, want, outs, outs_p, wrt, wrt_p, mk, mp, cot, inputs
    torch.cuda.empty_cache()
    return tuple(out)


def garden_preprocess_inputs(n: int, w: int, h: int, seed: int = 3):
    """``n`` Gaussians drawn on the card from ``seed``: means in the cube the
    demo scene fills, log-normal scales, random quaternions and opacities,
    SH degree 3 rows, a zero offset; and the demo camera at ``w`` x ``h``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda", generator=g)
    inputs = {
        "means3d": (torch.rand((n, 3), **dev) * 2.4 - 1.2),
        "scales": torch.exp(torch.randn((n, 3), **dev) * 0.6 - 4.6),
        "rotations": torch.randn((n, 4), **dev),
        "opacities": torch.sigmoid(torch.randn((n,), **dev)),
        "shs": torch.randn((n, 16, 3), **dev) * 0.3,
        "offset": torch.zeros((n, 2), device="cuda")}
    return inputs, demo.demo_camera(w, h)


def phase_preprocess(params, state) -> dict:
    """The preprocess kernels against the plain version at the two
    workloads, each with ``preprocess_cases``' edge rows appended, with the
    benchmark's settings (32x32 tiles, tight rects, the offset), under the
    card tests' gate (``preprocess_cases.assert_held``): forward floats to
    each row's scale, backward leaves to the largest |gradient| of their
    group's band (``magnitude_bands``: the largest 0.1 % of the bulk's rows
    apart, as the garden cloud holds Gaussians near the camera's plane),
    each as close to the float64 plain version as the float32 one is, or
    within 1e-5; at garden size the depths bit for bit;
    integer outputs equal but on at most 1e-5 of the rows; two backward
    launches bit-equal; then per call, the kernels' device time (profiler)
    and back-to-back time (CUDA events), the plain version's, and the bytes
    bound. Returns the kernels line's two rows, the garden workload's
    numbers, both workloads' under "workloads"."""
    per = {"preprocess_fwd": [], "preprocess_bwd": []}
    for name, (n, w, h) in PRE_WORKLOADS.items():
        if name == "800p":
            # the demo cloud's quaternions are all identity and its scales
            # isotropic, which leaves no rotation gradient: random ones, and
            # scales stretched per axis
            gen = torch.Generator(device="cuda").manual_seed(4)
            stretch = torch.exp(0.5 * torch.randn((n, 3), device="cuda",
                                                  generator=gen))
            inputs = {"means3d": params.xyz,
                      "scales": gm.get_scaling(params) * stretch,
                      "rotations": torch.randn((n, 4), device="cuda",
                                               generator=gen),
                      "opacities": gm.get_opacity(params, state.alive),
                      "shs": gm.get_features(params),
                      "offset": torch.zeros((n, 2), device="cuda")}
            cam = demo.demo_camera(w, h)
        else:
            inputs, cam = garden_preprocess_inputs(n, w, h)
        inputs, groups = cases.append_edges(
            {k: v.detach().contiguous() for k, v in inputs.items()}, cam)
        rows_n = len(groups)
        leaves = ("means3d", "scales", "rotations", "shs", "offset")

        def make(grad, dtype=torch.float32):
            ins = {k: v.detach().to(dtype, copy=True) for k, v in
                   inputs.items()}
            for k in leaves if grad else ():
                ins[k].requires_grad_()
            c = cam
            if dtype != torch.float32:
                c = copy.copy(cam)
                for k in ("view", "full_proj", "campos"):
                    setattr(c, k, getattr(cam, k).to(dtype))
            return ins, c

        def call(fn, made):
            ins, c = made
            pre = fn(ins["means3d"], ins["scales"], ins["rotations"],
                     ins["opacities"], ins["shs"], SH_DEGREE, c, 32, 32,
                     tight=True, means2d_offset=ins["offset"])
            return pre, [ins[k] for k in leaves]

        def held(label, *args):
            try:
                return cases.assert_held(label, *args)
            except AssertionError as e:
                fail(f"preprocess {label} ({name}): further from the "
                     f"float64 plain version than the float32 one, in rows "
                     f"{e}")

        plain_in, ref_in = make(False), make(False, torch.float64)
        with torch.no_grad():
            got, _ = call(pp.preprocess_gaussians, plain_in)
            want, _ = call(pp.preprocess_gaussians_reference, plain_in)
            ref, _ = call(pp.preprocess_gaussians_reference, ref_in)
        del ref_in
        torch.cuda.synchronize()
        same_depths = torch.equal(got.depths, want.depths)
        print(f"preprocess forward ({name}): depths bit-equal to the plain "
              f"version's: {same_depths}")
        check(same_depths or name != "garden",
              f"preprocess forward ({name}): the depths are not the plain "
              "version's bits; binning sorts by them, so two overlapping "
              "Gaussians an ulp apart blend in the other order (the "
              "benchmark's render compared with its reference turns "
              "incorrect): the kernels' view transform (affine_row) no "
              "longer sums as cuBLAS does at this size")
        err = 0.0
        for field in ("means2d", "depths", "conic", "rgb"):
            r = getattr(ref, field)
            err = max(err, held(f"forward {field}", getattr(got, field),
                                getattr(want, field), r, groups,
                                cases.row_scale(field, r, cam)))
        differ = torch.zeros(rows_n, dtype=torch.bool, device="cuda")
        for field in ("radii", "rect_min", "rect_max", "tiles_touched"):
            differ |= (getattr(got, field) != getattr(want, field)).reshape(
                rows_n, -1).any(dim=1)
        check(int(differ.sum()) <= 1e-5 * rows_n,
              f"preprocess forward ({name}): {int(differ.sum())} rows differ "
              "in an integer output")
        gen = torch.Generator(device="cuda").manual_seed(5)
        live = (want.radii > 0)[:, None]
        cot = [torch.where(live, torch.randn((rows_n, c), device="cuda",
                                             generator=gen) * s, 0.0)
               for c, s in ((2, 1e-2), (3, 1e-1), (3, 1.0))]
        pre_k, leaves_k = call(pp.preprocess_gaussians, make(True))
        pre_p, leaves_p = call(pp.preprocess_gaussians_reference, make(True))
        pre_r, leaves_r = call(pp.preprocess_gaussians_reference,
                               make(True, torch.float64))
        outs_k = [pre_k.means2d, pre_k.conic, pre_k.rgb]
        outs_p = [pre_p.means2d, pre_p.conic, pre_p.rgb]
        gk = torch.autograd.grad(outs_k, leaves_k, cot, retain_graph=True)
        again = torch.autograd.grad(outs_k, leaves_k, cot, retain_graph=True)
        gp = torch.autograd.grad(outs_p, leaves_p, cot, retain_graph=True)
        gr = torch.autograd.grad([pre_r.means2d, pre_r.conic, pre_r.rgb],
                                 leaves_r, [c.double() for c in cot])
        del pre_r, leaves_r
        gerr = 0.0
        for leaf, a, b, c, r in zip(leaves, gk, again, gp, gr):
            check(torch.equal(a, b), f"two preprocess backward launches "
                  f"differ ({name}, {leaf})")
            gerr = max(gerr, held(f"backward {leaf}", a, c, r,
                                  cases.magnitude_bands(groups, r)))
        del gr, ref

        def fwd_kernel():
            with torch.no_grad():
                call(pp.preprocess_gaussians, plain_in)

        def fwd_plain():
            with torch.no_grad():
                call(pp.preprocess_gaussians_reference, plain_in)

        def bwd_kernel():
            torch.autograd.grad(outs_k, leaves_k, cot, retain_graph=True)

        def bwd_plain():
            torch.autograd.grad(outs_p, leaves_p, cot, retain_graph=True)

        b_fwd, b_bwd = preprocess_bytes(rows_n, SH_DEGREE, True)
        for kernel, fn, plain, nbytes, e in (
                ("preprocess_fwd", fwd_kernel, fwd_plain, b_fwd, err),
                ("preprocess_bwd", bwd_kernel, bwd_plain, b_bwd, gerr)):
            ms = device_ms(fn, reps=20)
            dispatch_ms = cuda_ms(fn, reps=20, warmup=2)
            plain_ms = cuda_ms(plain, reps=3)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"{kernel} {name}: {rows_n} Gaussians at {w}x{h}, SH "
                  f"{SH_DEGREE}, tight, offset: device time per call "
                  f"(profiler, 20 calls) {ms:.4f} ms, back-to-back calls "
                  f"(CUDA events) {dispatch_ms:.4f} ms, plain version "
                  f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms by bytes "
                  f"({nbytes} B), {100 * bound_ms / ms:.1f} % of it; "
                  f"largest error from the float64 plain version {e:.3e} "
                  "of its scale (each row's, or its band's largest)")
            per[kernel].append({
                "workload": name, "gaussians": rows_n, "width": w,
                "height": h,
                "ms": ms, "dispatch_ms": dispatch_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "max_rel_err": e})
        del got, want, pre_k, pre_p, outs_k, outs_p, gk, again, gp, inputs
        del plain_in
        torch.cuda.empty_cache()
    for n in COLOR_WORKLOADS:
        for kernel, got in zip(("preprocess_fwd", "preprocess_bwd"),
                               preprocess_colors(n)):
            per[kernel].append(got)
    rows = {}
    for kernel, source in (("preprocess_fwd", "preprocess_fwd.cu"),
                           ("preprocess_bwd", "preprocess_bwd.cu")):
        g = per[kernel][0]
        row = kernel_row(kernel, source, "none: the JAX package leaves "
                         "preprocess to XLA", None, g["ms"],
                         g["dispatch_ms"], g["plain_ms"], g["bound_ms"], 0.0)
        # the error is relative: to each row's scale, or to its band's
        # largest |gradient|
        del row["max_abs_err"]
        row["max_rel_err"] = g["max_rel_err"]
        row["workloads"] = per[kernel]
        rows[kernel] = row
    return rows


# The binning kernels' workloads: "garden" is the garden cells' call (the
# preprocess phase's 5M-Gaussian cloud at 1297x840, 32x32 tiles, tight
# rects, precise cull, the exact key, buffers by the benchmark's probe rule);
# "neural" is neural800.train's z-buffer call (300k Gaussians at 800x800,
# the packed key, no cull, capacity 2^19), as zbuffer_pallas.zbuf_inputs
# makes it.
BIN_NEURAL = (300_000, 800, 800)


def expansion_keys(pre, inst, num_tiles, pack):
    """The kept instances' sort keys in expansion order (by eid), the
    sort's input, rebuilt from the plain version's ``inst``: a valid slot
    of tile t holds eid e and gid g, so key e is (t << shift) + (g's depth
    bits >> (31 - shift)) (``binning.key_layout``). Every kept instance
    must hold a slot (nothing dropped)."""
    check(int(inst.dropped) == 0, "the sort's input needs every kept "
          f"instance in a slot; {int(inst.dropped)} dropped")
    shift = binning.key_layout(num_tiles, pack)[1]
    valid = inst.valid
    tile = torch.repeat_interleave(
        torch.arange(num_tiles, device=valid.device), inst.tile_count.long())
    depth = pre.depths.view(torch.int32)[inst.gid[valid].long()].long()
    keys = torch.empty(tile.numel(), dtype=torch.int64, device=valid.device)
    keys[inst.eid[valid].long()] = (tile << shift) + (depth >> (31 - shift))
    return keys.to(torch.int32) if pack else keys


def binning_workloads():
    """{name: (pre, args, kw)} of the binning phase's two calls."""
    n, w, h = PRE_WORKLOADS["garden"]
    inputs, cam = garden_preprocess_inputs(n, w, h)
    with torch.no_grad():
        pre = pp.preprocess_gaussians(
            inputs["means3d"], inputs["scales"], inputs["rotations"],
            inputs["opacities"], inputs["shs"], SH_DEGREE, cam, 32, 32,
            tight=True)
    tx, ty = -(-w // 32), -(-h // 32)
    probe = binning.bin_gaussians(pre, tx, ty, 1 << 24, 1 << 20, 128,
                                  precise_cull=True, block_x=32, block_y=32,
                                  width=w, height=h)
    cap, kcap = bench_garden.size_from_probe(int(probe.num_rendered),
                                             int(probe.aligned_demand))
    max_per_tile = 4096  # the pipeline's, doubled to hold the densest tile
    while max_per_tile < int(probe.max_tile_load):
        max_per_tile *= 2
    garden = (pre, (tx, ty, cap, max_per_tile, 128),
              dict(precise_cull=True, packed_capacity=kcap, block_x=32,
                   block_y=32, width=w, height=h))
    n, w, h = BIN_NEURAL
    means = garden_preprocess_inputs(n, w, h, seed=9)[0]["means3d"]
    neural = zbuffer_pallas.binning_call(means, demo.demo_camera(w, h),
                                         TILE_CAPACITY)[:3]
    return {"garden": garden, "neural": neural}


def binning_bytes(n, kept, kcap, tiles, passes, key_bytes, cull):
    """(all, sort) bytes the binning moves as the function needs them: the
    Gaussians' inputs read once (tiles_touched, rects and depth; conic,
    opacity and centre under the cull), each kept (key, eid) pair written
    once and read and written once per sort pass, the gid of each kept
    instance written and read once, and the outputs written once (gid, eid,
    valid per packed slot, start and count per tile, gstart and gcount per
    Gaussian); the sort alone moves the pairs its passes read and write."""
    pair = key_bytes + 4
    sort = 2 * passes * pair * kept
    inputs = n * (4 + 16 + 4 + (24 if cull else 0))
    outputs = 9 * kcap + 8 * tiles + 8 * n
    return inputs + pair * kept + 8 * kept + sort + outputs, sort


def phase_binning() -> dict:
    """The binning kernels at the two workloads: ``Instances`` bit-equal to
    the plain version's on the same inputs, one launch counted; then per
    call, the kernels' device time (profiler, 20 calls) and back-to-back
    time (CUDA events), the plain version's, and the bytes bound; and the
    same for the sort alone, on the kept keys in expansion order, rebuilt
    from the plain version's instances (each call copies them in first: the profiler's time reads the sort's kernels
    alone, the events' time less that of the copy alone). Returns the
    kernels line's two rows, the garden workload's numbers, both
    workloads' under "workloads"."""
    per = {"binning": [], "binning_sort": []}
    for name, (pre, args, kw) in binning_workloads().items():
        tx, ty = args[0], args[1]
        n, tiles = pre.tiles_touched.shape[0], tx * ty
        before = binning.launches
        got = binning.bin_gaussians(pre, *args, **kw)
        check(binning.launches == before + 1,
              f"binning {name}: {binning.launches - before} launches")
        want = binning.bin_gaussians_reference(pre, *args, **kw)
        for field in want._fields:
            check(torch.equal(getattr(got, field), getattr(want, field)),
                  f"binning {name}: {field} differs from the plain version")
        pack = kw.get("pack_keys", False)
        bits = binning.key_layout(tiles, pack)[0]
        passes = binning.sort_passes(bits)
        src = expansion_keys(pre, want, tiles, pack)
        kept = src.numel()
        check(kept == int(want.gcount.sum()),
              f"binning {name}: {kept} kept, the plain version "
              f"{int(want.gcount.sum())}")
        live = torch.tensor([kept], dtype=torch.int32, device=src.device)
        buf = torch.empty_like(src)
        sorted_keys, _ = binning.radix_sort(buf.copy_(src), live, bits)
        check(torch.equal(sorted_keys[:kept],
                          torch.sort(src, stable=True).values),
              f"binning {name}: the sort alone differs from torch.sort")

        def kernels():
            binning.bin_gaussians(pre, *args, **kw)

        def plain():
            binning.bin_gaussians_reference(pre, *args, **kw)

        def sort():
            binning.radix_sort(buf.copy_(src), live, bits)

        def copy_only():
            buf.copy_(src)

        domain = (n * kw["dense_cap"] if kw.get("expand") == "dense"
                  else args[2])
        kcap = kw.get("packed_capacity") or args[2]
        b_all, b_sort = binning_bytes(n, kept, kcap, tiles, passes,
                                      4 if pack else 8,
                                      kw.get("precise_cull", False))
        sort_kernels = ("upsweep_kernel", "scan_kernel", "downsweep_kernel")
        for kernel, fn, nbytes in (("binning", kernels, b_all),
                                   ("binning_sort", sort, b_sort)):
            if kernel == "binning":
                ms = device_ms(fn, reps=20)
                dispatch_ms = cuda_ms(fn, reps=20, warmup=2)
                plain_ms = cuda_ms(plain, reps=3)
                parts = timing.kernel_ms(
                    profiled(lambda: [fn() for _ in range(20)], fn), 20)
                print(f"binning {name} by kernel (ms a call): " + ", ".join(
                    f"{re.sub(r'<.*$', '', k.split('(')[0]).split('::')[-1]}"
                    f" {v:.4f}"
                    for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))
            else:
                events = profiled(lambda: [sort() for _ in range(20)], sort)
                ms = sum(v for k, v in timing.kernel_ms(events, 20).items()
                         if any(s in k for s in sort_kernels))
                dispatch_ms = (cuda_ms(fn, reps=20, warmup=2)
                               - cuda_ms(copy_only, reps=20, warmup=2))
                plain_ms = cuda_ms(lambda: torch.sort(src, stable=True),
                                   reps=5)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"{kernel} {name}: {n} Gaussians, {tiles} tiles, "
                  f"{int(want.num_rendered)} instances, {kept} kept, "
                  f"{int(want.dropped)} dropped, domain "
                  f"{domain}, {bits}-bit key in {passes} passes: device "
                  f"time per call (profiler, 20 calls) {ms:.4f} ms, "
                  f"back-to-back calls (CUDA events) {dispatch_ms:.4f} ms, "
                  f"{'plain version' if kernel == 'binning' else 'torch.sort of the kept keys'} "
                  f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms by bytes "
                  f"({nbytes} B), {100 * bound_ms / ms:.1f} % of it")
            per[kernel].append({
                "workload": name, "gaussians": n, "kept": kept,
                "key_bits": bits, "passes": passes, "ms": ms,
                "dispatch_ms": dispatch_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms})
        del got, want, src, buf, sorted_keys
        torch.cuda.empty_cache()
    rows = {}
    for kernel, source in (("binning", "binning.cu"),
                           ("binning_sort", "binning_sort.cuh")):
        g = per[kernel][0]
        row = kernel_row(kernel, source, "none: the JAX package's binning "
                         "is XLA (ops/binning.py)", 0.0, g["ms"],
                         g["dispatch_ms"], g["plain_ms"], g["bound_ms"], 0.0)
        row["workloads"] = per[kernel]
        rows[kernel] = row
    return rows


# garden840.train's trainable groups: 5M rows of xyz 3, features_dc 1x3,
# features_rest 15x3, features 64 (which the classic render does not read:
# no gradient), scaling 3, rotation 4 and opacity 1 floats; 615M in all
ADAM_ROWS = 5_000_000
ADAM_SHAPES = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3),
               "features": (64,), "scaling": (3,), "rotation": (4,),
               "opacity": (1,)}


def adam_bytes(shapes: dict, no_grad) -> int:
    """Bytes of one Adam step as the function needs them: p, g, mu and nu
    read and p', mu' and nu' written once, 28 B an element; 24 for a group
    without a gradient."""
    return sum((24 if name in no_grad else 28) * math.prod(shape)
               for name, shape in shapes.items())


def phase_adam() -> dict:
    """The Adam kernel at garden840.train's groups, with dead slots (5 % of
    the rows, their gradients NaN) and ``features`` without a gradient:
    two steps bit-equal to the plain version (parameters and both moments),
    one launch each; then per step the kernel's device time (profiler, 20
    calls) and back-to-back time (CUDA events), the plain version's, and
    the bytes bound. Returns the kernels line's row."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    tx = optim.make_optimizer(optim.OptimizationParams(), 1.0)
    shapes = {k: (ADAM_ROWS,) + s for k, s in ADAM_SHAPES.items()}
    params = {k: torch.randn(s, device="cuda", generator=gen)
              for k, s in shapes.items()}
    alive = torch.rand(ADAM_ROWS, device="cuda", generator=gen) > 0.05
    grads = {k: torch.where(alive.reshape((-1,) + (1,) * (len(s) - 1)),
                            torch.randn(s, device="cuda", generator=gen)
                            * 1e-3, float("nan"))
             for k, s in shapes.items() if k != "features"}
    grads["features"] = None
    state = tx.init(params)
    optim.launches = 0
    for step in range(2):
        got = tx.update(grads, state, params, alive=alive)
        want = tx.update_reference(grads, state, params, alive=alive)
        for name in shapes:
            check(torch.equal(got[0][name], want[0][name])
                  and torch.equal(got[1][name].mu, want[1][name].mu)
                  and torch.equal(got[1][name].nu, want[1][name].nu),
                  f"adam step {step + 1}: {name} is not the plain "
                  "version's bits")
        params, state = got
        del want, got
    check(optim.launches == 2,
          f"2 Adam steps launched the kernel {optim.launches} times")

    def kernel():
        tx.update(grads, state, params, alive=alive)

    def plain():
        tx.update_reference(grads, state, params, alive=alive)

    ms = device_ms(kernel, reps=20)
    dispatch_ms = cuda_ms(kernel, reps=20, warmup=2)
    plain_ms = cuda_ms(plain, reps=3)
    nbytes = adam_bytes(shapes, ("features",))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    floats = sum(math.prod(s) for s in shapes.values())
    print(f"adam_update garden: {len(shapes)} groups, {floats} floats "
          f"({ADAM_ROWS} rows, 5 % dead, features without a gradient), "
          f"bit-equal to the plain version over 2 steps, 1 launch a step; "
          f"device time per step (profiler, 20 calls) {ms:.4f} ms, "
          f"back-to-back steps (CUDA events) {dispatch_ms:.4f} ms, plain "
          f"version {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by bytes "
          f"({nbytes} B), {100 * bound_ms / ms:.1f} % of it")
    row = kernel_row("adam_update", "adam_update.cu", "none: the JAX "
                     "package leaves Adam to XLA (optax)", 0.0, ms,
                     dispatch_ms, plain_ms, bound_ms, 0.0)
    row["floats"] = floats
    del params, state, grads
    torch.cuda.empty_cache()
    return row


# The denoiser's kernels at the neural workload's 800x800, each input read
# once and each output written once, in floats a pixel: forward the map's
# 81 and the image's 3 read, the output's 3 written; backward the map, the
# image and the cotangent read, the map's and the image's gradients
# written. FP32 operations a pixel: forward 81 taps x 3 channels x (mul,
# add); backward the map's gradient 81 x (3 mul, 2 add) and the image's
# gather 81 x 3 x (mul, add) (the reflect fold's few adds not counted).
DENOISE_FLOATS = {"denoise_fwd": 81 + 3 + 3, "denoise_bwd": 2 * 81 + 3 * 3}
DENOISE_OPS = {"denoise_fwd": 81 * 3 * 2, "denoise_bwd": 81 * 5 + 81 * 3 * 2}


def phase_denoise() -> dict:
    """The denoiser's kernels through ``nets.denoise`` at 800x800, the
    image and the map as the decoders hand them over (``nets._hwc`` views
    of (1, C, H, W); the map's is the planes layout the kernels read): the
    forward bit-equal to the plain version (``nets.denoise_reference``),
    both gradients within SAME_CARD_REL of the largest |gradient| of
    autograd through it, one launch each way; then each kernel's device
    time (profiler, 20 calls) and back-to-back time (CUDA events), the
    plain version's forward and backward, and the bounds. Returns the
    kernels line's two rows."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    img = nets._hwc(torch.rand((1, 3, H, W), generator=gen, device="cuda"))
    ker = nets._hwc(torch.randn((1, 81, H, W), generator=gen,
                                device="cuda") * 0.2)
    cot = torch.randn((H, W, 3), generator=gen, device="cuda")
    check(denoise_ops.planes(ker) is ker,
          "the CNN's map is not read in place as planes")

    def graph(fn):
        a = img.detach().requires_grad_()
        b = ker.detach().requires_grad_()
        return fn(a, b, 9), (a, b)

    denoise_ops.launches = denoise_ops.bwd_launches = 0
    out, inputs = graph(nets.denoise)
    got = torch.autograd.grad(out, inputs, cot, retain_graph=True)
    check((denoise_ops.launches, denoise_ops.bwd_launches) == (1, 1),
          f"one denoiser call launched {denoise_ops.launches} forward and "
          f"{denoise_ops.bwd_launches} backward kernels")
    ref, ref_inputs = graph(nets.denoise_reference)
    want = torch.autograd.grad(ref, ref_inputs, cot, retain_graph=True)
    check(torch.equal(out, ref),
          "the denoiser's forward is not the plain version's bits")
    errs = []
    for name, g, w in zip(("image", "map"), got, want):
        scale = w.abs().max().item()
        errs.append((g - w).abs().max().item())
        check(errs[-1] <= SAME_CARD_REL * scale,
              f"the denoiser's {name} gradient is {errs[-1]} off against a "
              f"scale of {scale}")
    check(got[1].permute(2, 0, 1).is_contiguous(),
          "the map's gradient is not (81, H, W) planes")
    del got, want

    def fwd():
        with torch.no_grad():
            nets.denoise(img, ker)

    def plain_fwd():
        with torch.no_grad():
            nets.denoise_reference(img, ker, 9)

    calls = {"denoise_fwd": (fwd, plain_fwd, 0.0),
             "denoise_bwd": (lambda: torch.autograd.grad(
                 out, inputs, cot, retain_graph=True),
                 lambda: torch.autograd.grad(ref, ref_inputs, cot,
                                             retain_graph=True), max(errs))}
    rows = {}
    for name, (kernel, plain, err) in calls.items():
        ms = device_ms(kernel, reps=20)
        dispatch_ms = cuda_ms(kernel, reps=20, warmup=2)
        plain_ms = cuda_ms(plain, reps=3)
        nbytes = DENOISE_FLOATS[name] * 4 * H * W
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = DENOISE_OPS[name] * H * W / FP32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        print(f"{name} {W}x{H}: max |err| {err:.3g} (forward bit-equal to "
              f"the plain version; gradients within {SAME_CARD_REL} of "
              f"their scale); device time {ms:.4f} ms (profiler, 20 calls), "
              f"back to back {dispatch_ms:.4f} ms (CUDA events), plain "
              f"version {plain_ms:.4f} ms; bound {bound:.4f} ms by bytes "
              f"({nbytes} B; {t_ops:.4f} ms by operations), "
              f"{100 * bound / ms:.1f} % of it")
        rows[name] = kernel_row(
            name, f"{name}.cu", "none: the JAX package's denoise is 81 "
            "shifted slices, which XLA fuses", err, ms, dispatch_ms,
            plain_ms, t_bytes, t_ops)
    del out, ref, inputs, ref_inputs
    torch.cuda.empty_cache()
    return rows


def pair_ops(kernel, blend_ops, tile, association):
    """The operation count of a blend kernel as the function needs it
    (``blend.blend_pair_counts`` at ``tile`` (block_x, block_y), the
    power rounded in ``association``): forward ("k1", "k4") or backward
    ("k2", "k5"), ``blend_ops`` per blended pair; a ``count`` for
    ``fwd_parity`` and ``bwd_parity``. Fails unless the blended pairs, and
    the forward's visited pairs, are the plain version's."""
    side = "fwd" if kernel in ("k1", "k4") else "bwd"

    def count(args, raw, pairs, blended):
        n = blend.blend_pair_counts(*args[:4], *tile, raw, association)
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
    nbytes = (blend.PROWS * n_inst * 4 + 2 * num_tiles * 4
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
    image = blend.assemble_image(
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
    nbytes = (blend.PROWS * int(stop.sum()) * 4 + 2 * num_tiles * 4
              + num_tiles * (5 + 4) * tile[0] * tile[1] * 4
              + blend.PROWS * packed.shape[1] * 4)
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


def phase_serve(params, state, rows):
    """PLY save -> load, then render four views through the public API:
    one K1 and one preprocess forward launch a view, no backward."""
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
    pp.launches = pp.bwd_launches = binning.launches = 0
    outs = [render(cam, loaded, lstate.alive, deg, bg, SETTINGS)
            for cam in cams]
    torch.cuda.synchronize()
    launches, pre = blend_seq.launches, pp.launches
    check(launches == len(VIEWS),
          f"K1 launched {launches} times for {len(VIEWS)} renders")
    check(blend_seq.bwd_launches == 0, "a forward render launched K2")
    check(pre == len(VIEWS) and pp.bwd_launches == 0,
          f"{len(VIEWS)} renders launched the preprocess forward {pre} and "
          f"its backward {pp.bwd_launches} times")
    bins = binning.launches
    check(bins == len(VIEWS),
          f"{len(VIEWS)} renders ran the binning kernels {bins} times")
    rows["preprocess_fwd"]["serve_launches"] = pre
    rows["binning"]["serve_launches"] = bins
    rows["binning_sort"]["serve_launches"] = bins
    print(f"serve: K1 launched {launches} times, the preprocess forward "
          f"{pre} and the binning kernels {bins} times for {len(VIEWS)} "
          f"renders")
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
    pp.launches = pp.bwd_launches = optim.launches = binning.launches = 0
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
    pre, pre_bwd = pp.launches, pp.bwd_launches
    check(pre == TRAIN_STEPS and pre_bwd == TRAIN_STEPS,
          f"{TRAIN_STEPS} steps launched the preprocess forward {pre} and "
          f"its backward {pre_bwd} times")
    rows["K1"]["launches"], rows["K2"]["launches"] = k1, k2
    rows["preprocess_fwd"]["launches"] = pre
    rows["preprocess_bwd"]["launches"] = pre_bwd
    adam = optim.launches
    check(adam == TRAIN_STEPS,
          f"{TRAIN_STEPS} steps launched the Adam kernel {adam} times")
    rows["adam_update"]["launches"] = adam
    bins = binning.launches
    check(bins == TRAIN_STEPS,
          f"{TRAIN_STEPS} steps ran the binning kernels {bins} times")
    rows["binning"]["launches"] = rows["binning_sort"]["launches"] = bins
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
    print(f"train: K1 {k1}, K2 {k2}, preprocess forward {pre} and backward "
          f"{pre_bwd}, Adam {adam}, binning {bins} launches in {TRAIN_STEPS} "
          f"steps; loss "
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
    kernels = [e for e in device_records(prof.key_averages())
               if e.self_device_time_total > 0]
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


def phase_scene(tmp, rows):
    """The port's user path from files on disk: the demo-scene tool writes
    the 800x800 scene into ``tmp``, ``python -m
    neuralgaussiansplatting_torch.train``'s ``main`` trains it SCENE_ITERS
    iterations in this process (K1 and K2 once per iteration), a subprocess
    resumes from the halfway checkpoint, and a COLMAP-layout copy trains
    COLMAP_ITERS iterations at -r 2. Returns (scene directory, model
    directory, the resumed run's test PSNR at SCENE_ITERS, which is the
    saved model's, and the SHA-256 of the first run's saved PLY)."""
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
    # the resume below overwrites it
    ply_sha = file_sha(os.path.join(out, SCENE_FILES[0]))
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
    evals = re.findall(rf"\[ITER {SCENE_ITERS}\] Evaluating test: L1 "
                       r"[0-9.]+ PSNR ([0-9.]+)", res.stdout)
    check(len(evals) == 1, f"the resume printed {len(evals)} test "
          f"evaluations at {SCENE_ITERS}")
    resume_psnr = float(evals[0])
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
    return src, out, resume_psnr, ply_sha


def write_lpips_weights(path: str, seed: int = 0):
    """Seeded VGG16 weights in ``utils/lpips.py``'s schema: HWIO
    convolutions drawn at He's scale, zero biases, per-channel lin vectors
    in [0, 1/C)."""
    rng = np.random.default_rng(seed)
    out, cin, li = {}, 3, 0
    for c, n_convs in lpips.VGG16_STAGES:
        for _ in range(n_convs):
            out[f"conv{li}_w"] = (rng.normal(size=(3, 3, cin, c))
                                  * math.sqrt(2.0 / (9 * cin))).astype(
                                      np.float32)
            out[f"conv{li}_b"] = np.zeros(c, np.float32)
            cin, li = c, li + 1
    for i, (c, _) in enumerate(lpips.VGG16_STAGES):
        out[f"lin{i}_w"] = (rng.random(c) / c).astype(np.float32)
    np.savez(path, **out)


def read_pngs(folder: str) -> dict:
    return {name: image_io.read_png(os.path.join(folder, name))
            for name in sorted(os.listdir(folder))}


def phase_offline(tmp, src, out, run_psnr) -> dict:
    """The port's offline tools and neural entry point on the scene phase's
    files (module comment at OFFLINE_VIEWS). Returns the launches of K1 and
    K4 in the render entry and of K3 in the neural entry."""
    t_phase = time.perf_counter()
    counts = {}
    it = SCENE_ITERS
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    summary = render_entry.main(["-m", out] + RENDER_ARGS)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launched = launch_counts()
    views = sum(OFFLINE_VIEWS.values())
    check(summary["iteration"] == it, f"render loaded {summary['iteration']}")
    check({k: v["views"] for k, v in summary["splits"].items()}
          == OFFLINE_VIEWS, f"render views {summary['splits']}")
    check(launched["K1"] == views and launched["K4"] == 0,
          f"render of {views} views launched {launched}")
    check(summary["dropped"] == 0,
          f"the renders dropped up to {summary['dropped']} instances")
    for split, n in OFFLINE_VIEWS.items():
        for kind in ("renders", "gt"):
            d = os.path.join(out, split, f"ours_{it}", kind)
            check(sorted(os.listdir(d)) == [f"{i:05d}.png" for i in range(n)],
                  f"{d} holds {sorted(os.listdir(d))}")
    counts["K1"] = launched["K1"]
    loop_s = sum(v["seconds"] for v in summary["splits"].values())
    png_s = sum(v["png_s"] for v in summary["splits"].values())
    print(f"offline render: {views} views ({OFFLINE_VIEWS}) through the "
          f"render entry point ({' '.join(RENDER_ARGS)}) in {render_s:.2f} s "
          f"({render_s - loop_s:.2f} s loading the scene and model), "
          f"{1e3 * loop_s / views:.2f} ms per view, of which "
          f"{1e3 * png_s / views:.2f} ms convert and write its render and GT "
          f"PNGs (host clock); K1 {launched['K1']}, K4 {launched['K4']} "
          f"launches; largest dropped 0, densest tile "
          f"{max(v['max_per_tile'] for v in summary['splits'].values())}, "
          f"most instances "
          f"{max(v['num_rendered'] for v in summary['splits'].values())}")

    weights = os.path.join(tmp, "lpips_vgg.npz")
    write_lpips_weights(weights)
    os.environ["NGS_LPIPS_WEIGHTS"] = weights
    lpips._load_params.cache_clear()
    try:
        t0 = time.perf_counter()
        scores = metrics_entry.main(["-m", out])[out][f"ours_{it}"]
        metrics_s = time.perf_counter() - t0
        check(all(math.isfinite(scores[k]) for k in ("SSIM", "PSNR", "LPIPS")),
              f"metrics: {scores}")
        check(abs(scores["PSNR"] - run_psnr) <= OFFLINE_PSNR_GATE,
              f"metrics' PSNR {scores['PSNR']:.4f} lies more than "
              f"{OFFLINE_PSNR_GATE} dB from the run's {run_psnr:.2f}")
        fn = lpips.lpips_fn("vgg", device="cuda")
        test_dir = os.path.join(out, "test", f"ours_{it}")
        img = image_io.read_png(os.path.join(test_dir, "renders", "00000.png"))
        gt = image_io.read_png(os.path.join(test_dir, "gt", "00000.png"))
        a, b = (torch.from_numpy(np.ascontiguousarray(
            x[..., :3].astype(np.float32).transpose(2, 0, 1) / 255.0)).cuda()
                for x in (img, gt))
        self_dist = fn(a, a)
        check(abs(self_dist) <= 1e-6, f"LPIPS of an image to itself "
              f"{self_dist}")
        fn(a, b)
        t0 = time.perf_counter()
        for _ in range(5):
            fn(a, b)
        lpips_ms = (time.perf_counter() - t0) * 1e3 / 5
    finally:
        del os.environ["NGS_LPIPS_WEIGHTS"]
        lpips._load_params.cache_clear()
    print(f"offline metrics: {OFFLINE_VIEWS['test']} test views scored in "
          f"{metrics_s:.2f} s: SSIM {scores['SSIM']:.5f}, PSNR "
          f"{scores['PSNR']:.4f} dB (the run's test PSNR at {it}: "
          f"{run_psnr:.2f}), LPIPS {scores['LPIPS']:.6f} (synthetic "
          f"weights); LPIPS {lpips_ms:.2f} ms per {img.shape[1]}x"
          f"{img.shape[0]} pair (host clock, mean of 5), {self_dist:.1e} to "
          f"itself")

    seq_renders = read_pngs(os.path.join(test_dir, "renders"))
    reset_launch_counts()
    summary = render_entry.main(["-m", out] + PALLAS_RENDER_ARGS)
    torch.cuda.synchronize()
    launched = launch_counts()
    check(launched["K4"] == OFFLINE_VIEWS["test"] and launched["K1"] == 0,
          f"the pallas render of {OFFLINE_VIEWS['test']} views launched "
          f"{launched}")
    check(summary["dropped"] == 0,
          f"the pallas renders dropped up to {summary['dropped']}")
    counts["K4"] = launched["K4"]
    diffs = [np.abs(image.astype(np.int16) - seq_renders[name])
             for name, image in read_pngs(os.path.join(test_dir,
                                                       "renders")).items()]
    print(f"offline render {' '.join(PALLAS_RENDER_ARGS)}: "
          f"densest tile {summary['splits']['test']['max_per_tile']}, most "
          f"instances {summary['splits']['test']['num_rendered']}; "
          f"{launched['K4']} K4 launches, "
          f"K1 0, dropped 0; its test PNGs against the seq ones: max "
          f"{max(int(d.max()) for d in diffs)} levels, "
          f"{np.mean([(d > 0).mean() for d in diffs]):.6f} of the values "
          f"differ")

    out_n = os.path.join(tmp, "out_neural")
    ckpt_path = os.path.join(out, f"chkpnt{SCENE_CHECKPOINT}.ckpt")
    torch.cuda.synchronize()
    reset_launch_counts()
    summary = trainn_entry.main(
        ["-s", src, "-m", out_n, "--eval", "--start_checkpoint", ckpt_path,
         "--sw", "2", "--iterations", str(TRAINN_ITERS), "--test_iterations",
         "1", str(TRAINN_ITERS), "--video_interval", str(TRAINN_ITERS),
         "--analysis_interval", str(TRAINN_ANALYSIS), "--quiet"])
    torch.cuda.synchronize()
    counts["K3"] = zbuffer_pallas.launches
    check(counts["K3"] >= TRAINN_ITERS,
          f"{TRAINN_ITERS} neural iterations launched K3 {counts['K3']} times")
    check(math.isfinite(summary["last_loss"]),
          f"neural entry: last loss {summary['last_loss']}")
    psnr = {i: summary["evals"][i]["test"][1] for i in (1, TRAINN_ITERS)}
    check(psnr[TRAINN_ITERS] >= psnr[1] + TRAINN_PSNR_GAIN,
          f"neural test PSNR {psnr[1]:.3f} -> {psnr[TRAINN_ITERS]:.3f} dB "
          f"gained less than {TRAINN_PSNR_GAIN} dB")
    video = os.path.join(out_n, "video", f"iter_{TRAINN_ITERS}")
    frames = os.listdir(os.path.join(video, "rgb"))
    archives = [f for f in os.listdir(video) if f.endswith(".npz")]
    check(len(frames) == summary["video_frames"] == VIDEO_FRAMES
          and len(archives) == VIDEO_ARCHIVES,
          f"video: {len(frames)} frames, archives {archives}")
    analysis = os.path.join(out_n, "feature_analysis")
    with open(os.path.join(analysis, "history.csv")) as f:
        rows = f.read().splitlines()[1:]
    plots = [f for f in os.listdir(analysis) if f.endswith(".png")]
    check(len(rows) == TRAINN_ITERS // TRAINN_ANALYSIS,
          f"history.csv holds {len(rows)} rows")
    check(bool(plots) == summary["plots"],
          f"plots {'written' if summary['plots'] else 'skipped'}, "
          f"{len(plots)} files")

    ckpt = torch.load(ckpt_path, weights_only=True)
    alive = ckpt["gstate"]["alive"]
    want = gm.normalize_params(gm.GaussianParams(**ckpt["params"]))
    got, _, _ = gm.load_ply(os.path.join(
        out_n, "point_cloud", f"iteration_{TRAINN_ITERS}", "point_cloud.ply"),
        device="cpu")
    for field in ("xyz", "scaling", "rotation", "opacity"):
        check(torch.equal(getattr(got, field), getattr(want, field)[alive]),
              f"the neural run moved the frozen {field}")
    check(not torch.equal(got.features, want.features[alive]),
          "the neural run left the features as the checkpoint's")
    print(f"offline trainn: --sw 2 from {os.path.basename(ckpt_path)} "
          f"({int(alive.sum())} Gaussians), {TRAINN_ITERS} iterations through "
          f"the neural entry point in {summary['wall_s']:.2f} s, median "
          f"iteration {summary['median_iter_ms']:.3f} ms (host clock, "
          f"{len(summary['iter_ms'])} iterations without evaluation, video, "
          f"analysis or writes); K3 {counts['K3']} launches; test PSNR "
          f"{psnr[1]:.3f} -> {psnr[TRAINN_ITERS]:.3f} dB (train views "
          f"{summary['evals'][1]['train'][1]:.3f} -> "
          f"{summary['evals'][TRAINN_ITERS]['train'][1]:.3f}); video "
          f"{len(frames)} frames and {len(archives)} archives in "
          f"{summary['video_s']:.2f} s; feature analysis "
          f"{summary['analysis_s']:.2f} s, plots "
          f"{'written' if summary['plots'] else 'skipped (no matplotlib)'}; "
          f"geometry bit-equal to the checkpoint's, features trained")
    print(f"offline: the phase took {time.perf_counter() - t_phase:.2f} s; "
          f"card: {card_line()}")
    return counts


def phase_breakdown(params, state):
    """Where a render's time goes: the device's busy share over whole
    renders and its top kernels from torch.profiler. The trace carries the
    render's stage spans; ``python -m ngsbench.stages`` charges each kernel
    to its stage."""
    cam = demo.demo_camera(W, H)
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
    its rows and the cloud."""
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
    return rows, (params, state, cam)


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


def phase_neural_train(params, state, rows):
    """10 ``NeuralTrainer(sw=2)`` steps towards the classic render (K1) of
    the same cloud. Puts the launches of K3, of the denoiser's pair and of
    the binning kernels in them into ``rows``."""
    cam = demo.demo_camera(W, H)
    with torch.no_grad():
        gt = render(cam, params, state.alive, NEURAL_SH,
                    torch.zeros(3, device="cuda"), SETTINGS)["render"]
    model = gm.GaussianModel(NEURAL_SH)
    model.params, model.state = params, state
    trainer = neural_loop.NeuralTrainer(model, sw=2, capacity=TILE_CAPACITY)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zbuffer_pallas.launches = optim.launches = binning.launches = 0
    denoise_ops.launches = denoise_ops.bwd_launches = 0
    step_ms, metrics = [], []
    for _ in range(NEURAL_STEPS):
        t0 = time.perf_counter()
        metrics.append(trainer.step(cam, gt))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = zbuffer_pallas.launches
    check(launches == NEURAL_STEPS,
          f"{NEURAL_STEPS} steps launched K3 {launches} times")
    for name, count in (("forward", denoise_ops.launches),
                        ("backward", denoise_ops.bwd_launches)):
        check(count == NEURAL_STEPS, f"{NEURAL_STEPS} steps launched the "
              f"denoiser's {name} kernel {count} times")
    # the z-buffer bins once a step
    bins = binning.launches
    check(bins == NEURAL_STEPS,
          f"{NEURAL_STEPS} steps ran the binning kernels {bins} times")
    rows["binning"]["neural_launches"] = bins
    rows["binning_sort"]["neural_launches"] = bins
    # the features in one launch, the decoders' leaves in MAX_GROUPS a
    # launch
    n_leaves = len(neural_loop.decoder_leaves(trainer.ts.net_params))
    adam = 1 + -(-n_leaves // optim.MAX_GROUPS)
    check(optim.launches == adam * NEURAL_STEPS,
          f"{NEURAL_STEPS} steps launched the Adam kernel {optim.launches} "
          f"times, not {adam} a step ({n_leaves} decoder leaves)")
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
    print(f"neural train: NeuralTrainer(sw=2), K3 {launches}, denoiser "
          f"{denoise_ops.launches} + {denoise_ops.bwd_launches}, binning "
          f"{bins} and Adam {optim.launches} launches in {NEURAL_STEPS} "
          f"steps; loss {loss[0]:.5f} -> {loss[-1]:.5f} (mean "
          f"of first 3 {first:.5f}, last 3 {last:.5f}); psnr "
          f"{metrics[0]['psnr'].item():.3f} -> "
          f"{metrics[-1]['psnr'].item():.3f}; hit rate "
          f"{metrics[-1]['hit_rate'].item():.4f}")
    print(f"neural train timing: median step {step:.3f} ms (host clock, "
          f"synchronised, {NEURAL_STEPS - 2} steps), {W * H / step / 1e3:.3f} "
          f"Mpix/s; peak memory {peak:.2f} GiB")
    rows["K3"]["launches"] = launches
    rows["denoise_fwd"]["launches"] = denoise_ops.launches
    rows["denoise_bwd"]["launches"] = denoise_ops.bwd_launches


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
    input and a seeded input with |x| < 2^20 and a negative x[0, 0]; then
    each probe, its one-call counterpart (held to the plain version in
    tests/test_torch_probes.py) and the empty floor kernel timed in
    K7_TURNS alternating turns, and the wrapper's host cost part by part.
    Returns the kernels-line row: the slowest probe's numbers, every
    probe's under "probes"."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rand = (torch.rand((16, 128), generator=gen, device="cuda") * 2 - 1) \
        * 2 ** 20
    rand[0, 0] = -300.75
    arange = torch.arange(16 * 128, dtype=torch.float32,
                          device="cuda").reshape(16, 128)
    probes = []
    for name, (kernel, plain) in K7_PROBES.items():
        call, library = exp_mosaic_probe.COUNTERPARTS[name]
        worst = 0.0
        for label, x in (("arange", arange), ("random", rand)):
            got = kernel(x)
            torch.cuda.synchronize()
            want = plain(x)
            err = (got - want).abs().max().item()
            check(torch.equal(got, want), f"K7 probe {name} differs from its "
                  f"plain version on the {label} input: max|d| {err}")
            worst = max(worst, err)
        parts = {"probe": lambda: kernel(arange),
                 "floor": lambda: exp_mosaic_probe.launch_floor(
                     arange.device)}
        if library is not None:
            parts["library"] = lambda: library(arange)
        bound = ((K7_READS[name](arange) + got.numel()) * 4
                 / HBM_BYTES_PER_S * 1e3)
        entry = k7_turns(name, call, parts, bound)
        entry.update(
            name=name, replaces=exp_mosaic_probe.REPLACES[name],
            max_abs_err=worst, plain_ms=cuda_ms(lambda: plain(arange),
                                                reps=5),
            bound_ms=bound)
        probes.append(entry)
    bounds = [p["bound_ms"] for p in probes]
    print(f"k7: 10 probes equal to their plain versions on arange and a "
          f"seeded input; bounds {min(bounds):.3e}-{max(bounds):.3e} ms by "
          "bytes (the elements of x each function reads and its output, "
          "once at 3.35 TB/s), far below any launch: no single launch can "
          "reach half of one, so the floor is the yardstick")
    host = k7_host_split(arange)
    slowest = max(probes, key=lambda p: p["ms"])
    row = kernel_row("mosaic_probe", "mosaic_probe.cu", slowest["replaces"],
                     max(p["max_abs_err"] for p in probes), slowest["ms"],
                     slowest["dispatch_ms"],
                     slowest["plain_ms"], slowest["bound_ms"], 0.0,
                     slowest["library_ms"])
    row.update(floor_ms=slowest["floor_ms"],
               library_dispatch_ms=slowest["library_dispatch_ms"],
               probes=probes, host_us=host)
    return row


def k7_window(fns: dict, reps: int, launches: dict, tries: int = 5):
    """One profiler window (``profiled``, opened with one call of each of
    ``fns``): ``reps`` calls of each of ``fns`` ({part: fn}, parts "probe",
    "library", "floor") in the dict's order, the card synchronised after
    each part's calls. Returns ({part: device ms per call}, {part: kernels
    per call}, (windows taken, {part: least share of a kernel's records
    kept})) as ``parts_ms`` reads them, a part's kernels told by name
    (K7_KERNEL, floor_kernel: the probe's and the floor's; any other is
    the library's). A window whose kernels per call are not ``launches``
    ({part: launches per call}), or in which a kernel kept fewer than
    K7_LEAST_KEPT of its records, is taken again, up to ``tries`` times."""
    def lead_in():
        for fn in fns.values():
            fn()

    def run():
        for fn in fns.values():
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()

    def part_of(key):
        part = ("library" if not K7_KERNEL.search(key)
                else "floor" if "floor_kernel" in key else "probe")
        return part if part in fns else None

    for taken in range(1, tries + 1):
        ms, kernels, kept = parts_ms(profiled(run, lead_in), part_of, reps)
        if kernels == launches and min(kept.values()) >= K7_LEAST_KEPT:
            return ms, kernels, (taken, kept)
    raise RuntimeError(f"the profiler recorded no K7 window with "
                       f"{launches} kernels per call and at least "
                       f"{K7_LEAST_KEPT} of each kernel's records in {tries} "
                       f"tries: the last {kernels}, least share kept {kept}")


def k7_turns(name, call, parts: dict, bound_ms: float) -> dict:
    """``parts`` ({"probe", "floor"[, "library"]: fn}) in K7_TURNS turns,
    the order reversed every other turn: device time per launch (profiler,
    K7_REPS each) and back-to-back time (CUDA events, K7_DISPATCH_REPS).
    Prints the medians and spreads (max - min), the probe's bound by bytes
    and the targets met or missed; returns the probe's entry of the
    kernels line."""
    dev = {k: [] for k in parts}
    back = {k: [] for k in parts}
    launches = {"probe": 1, "floor": 1, "library":
                K7_LIBRARY_LAUNCHES.get(name, 1)}
    launches = {k: v for k, v in launches.items() if k in parts}
    windows, kept = 0, dict.fromkeys(parts, 1.0)
    for turn in range(K7_TURNS):
        order = list(parts) if turn % 2 == 0 else list(parts)[::-1]
        ms, kernels, (taken, least) = k7_window(
            {k: parts[k] for k in order}, K7_REPS, launches)
        windows += taken
        kept = {k: min(kept[k], least[k]) for k in parts}
        for k in order:
            dev[k].append(ms[k])
            back[k].append(cuda_ms(parts[k], reps=K7_DISPATCH_REPS,
                                   warmup=5))
    med = {k: statistics.median(v) for k, v in dev.items()}
    spread = {k: max(v) - min(v) for k, v in dev.items()}
    bmed = {k: statistics.median(v) for k, v in back.items()}
    gap = statistics.median(p - f for p, f in zip(dev["probe"],
                                                  dev["floor"]))
    entry = {"ms": med["probe"], "ms_spread": spread["probe"],
             "floor_ms": med["floor"], "floor_spread": spread["floor"],
             "over_floor_ms": gap, "dispatch_ms": bmed["probe"],
             "floor_dispatch_ms": bmed["floor"], "library": call,
             "library_ms": None, "library_dispatch_ms": None,
             "windows": windows, "records_kept": kept}
    text = (f"k7 {name} ({K7_TURNS} alternating turns; device ms per "
            f"launch, profiler, {K7_REPS} each / back-to-back ms, CUDA "
            f"events, {K7_DISPATCH_REPS} each): probe {med['probe']:.7f} "
            f"(spread {spread['probe']:.7f}) / {bmed['probe']:.5f}; floor "
            f"{med['floor']:.7f} ({spread['floor']:.7f}) / "
            f"{bmed['floor']:.5f}; probe - floor {gap:.7f}; bound "
            f"{bound_ms:.3e} by bytes; profiler windows {windows} for "
            f"{K7_TURNS} turns, least share of a kernel's records kept: "
            + ", ".join(f"{k} {v:.2f}" for k, v in kept.items()))
    targets = [f"(b) within {K7_FLOOR_GAP_MS} ms of the floor: "
               + ("met" if gap <= K7_FLOOR_GAP_MS else "missed")]
    if "library" in parts:
        lib_kernels = kernels["library"]
        wins = sum(p <= q for p, q in zip(dev["probe"], dev["library"]))
        text += (f"; {call} {med['library']:.7f} ({spread['library']:.7f})"
                 f" / {bmed['library']:.5f}, kernels per call "
                 f"{lib_kernels:g}; probe at or below it in {wins} of "
                 f"{K7_TURNS} turns")
        entry.update(library_ms=med["library"],
                     library_spread=spread["library"],
                     library_dispatch_ms=bmed["library"],
                     counterpart_kernels=lib_kernels, turns_won=wins)
        if lib_kernels != 1:
            entry["library"] = f"{call}, {lib_kernels:g} launches per call"
        targets.append(
            f"(c) back-to-back within {K7_DISPATCH_RATIO:g}x the "
            "counterpart's: " + ("met" if bmed["probe"]
                                 <= K7_DISPATCH_RATIO * bmed["library"]
                                 else "missed"))
        if name == "p6_transpose":
            targets.append("(a) at or below it: " + (
                "met" if med["probe"] <= med["library"] else "missed"))
    else:
        text += f"; counterpart {call}"
    print(text + "; targets " + ", ".join(targets))
    return entry


def k7_host_split(x) -> dict:
    """K7's wrapper on ``p6_transpose``: its host cost part by part (the
    checks, ``_build.on_cuda``'s among them, the output allocation, the
    device and stream lookup, the ctypes call refused before any launch,
    the ctypes call with the empty floor launch and with the probe's, the
    same through ``_build.launch``, the whole call), beside one
    ``x.t().contiguous()`` call. Returns {part: us}."""
    name = "p6_transpose"
    number, param, shape = exp_mosaic_probe._SPECS[name][:3]
    dev = x.device
    args = exp_mosaic_probe._ARGS
    fn, _ = _build._entry("mosaic_probe", args)
    floor_fn = exp_mosaic_probe._floor_entry()
    stream = _build.current_stream(dev)
    out = x.new_empty(shape)
    ptr, optr = x.data_ptr(), out.data_ptr()
    parts = {
        "checks": lambda: (
            x.dtype != torch.float32 or x.shape != exp_mosaic_probe.SHAPE,
            x.data_ptr() % 16, _build.on_cuda("mosaic_probe", (x,))),
        "allocation (new_empty)": lambda: x.new_empty(shape),
        "device and stream": lambda: (
            dev.index == torch.cuda.current_device(),
            _build.current_stream(dev)),
        "ctypes, refused": lambda: fn(-1, 0, ptr, optr, stream),
        "ctypes, floor launch": lambda: floor_fn(stream),
        "ctypes, probe launch": lambda: fn(number, param, ptr, optr, stream),
        "_build.launch, probe": lambda: _build.launch(
            "mosaic_probe", args, dev, number, param, ptr, optr),
        "whole call": lambda: exp_mosaic_probe.probe(name, x),
        "x.t().contiguous()": lambda: x.t().contiguous()}
    cost = {k: host_us(part) for k, part in parts.items()}
    print(f"k7 host cost per {name} call (host clock, median of "
          f"{HOST_ROUNDS} x {HOST_REPS} calls): " + ", ".join(
              f"{k} {v:.2f} us" for k, v in cost.items()))
    return cost


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



# -- the bench phase ------------------------------------------------------

def chain_launches(iters: int, reps: int) -> int:
    """Steps of one checked chain: ``chain``'s (reps + 1) * (iters + 1) and
    the checked step after it."""
    return (reps + 1) * (iters + 1) + 1


@contextlib.contextmanager
def checked_chains(owners, label: str, profiled: bool):
    """Each owner's ``chain`` replaced by the real one followed by one more
    step of the body from its first carry: its output must be finite, and
    with ``profiled`` it runs under the profiler, whose device-busy share
    is printed beside the chain's time."""
    real = chain_bench.chain
    from torch.profiler import ProfilerActivity, profile

    def chain(make_body, x0, iters=8, reps=3):
        ms = real(make_body, x0, iters=iters, reps=reps)
        check(math.isfinite(ms) and ms > 0, f"{label}: {ms} ms per step")
        body = make_body()
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            out = body(x0, 0.0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.isfinite(leaf).all().item()
                  for leaf in chain_bench._leaves(out)
                  if leaf.is_floating_point()),
              f"{label}: a chained step's output is not finite")
        if profiled:
            print(f"{label}, one step of the chain ({ms:.3f} ms chained):",
                  end=" ")
            report_profile(prof, wall_ms, 1, "step")
        return ms

    saved = [(owner, owner.chain) for owner in owners]
    for owner, _ in saved:
        owner.chain = chain
    try:
        yield
    finally:
        for owner, fn in saved:
            owner.chain = fn


def check_tool_launches(label: str, got: dict, want: dict):
    """A tool's launches (its own count) against ``want``, and the
    kernels' counters since the last reset against the same."""
    torch.cuda.synchronize()
    want = {k: v for k, v in want.items() if v}
    counted = {k: v for k, v in quality_counts().items() if v}
    check(got == want and counted == want,
          f"{label} launched {got} (counters {counted}), expected {want}")


def expected_drops(params, state, cam, settings, num_rendered: int) -> int:
    """The instances ``settings``' caps must drop: the dense cap's clip,
    then each tile's instances past ``max_per_tile``, counted by one
    binning without the per-tile cap into a packed buffer that holds every
    segment."""
    tiles_x, tiles_y = settings.tiles_for(cam.width, cam.height)
    with torch.no_grad():
        pre = pp.preprocess_gaussians(
            params.xyz, gm.get_scaling(params), gm.get_rotation(params),
            gm.get_opacity(params, state.alive), gm.get_features(params),
            SH_DEGREE, cam, settings.block_x, settings.block_y,
            tight=settings.tight_culling)
        inst = binning.bin_gaussians(
            pre, tiles_x, tiles_y, settings.capacity, 1 << 30,
            settings.chunk, pack_keys=settings.fast_sort,
            packed_capacity=num_rendered + tiles_x * tiles_y * settings.chunk,
            precise_cull=settings.precise_cull, block_x=settings.block_x,
            block_y=settings.block_y, width=cam.width, height=cam.height,
            expand=settings.expand, dense_cap=settings.dense_cap)
    over = torch.clamp_min(inst.tile_count.long() - settings.max_per_tile, 0)
    return int(inst.dropped) + int(over.sum())


def phase_bench_garden(params, state, cam) -> dict:
    """``tools.bench_garden``'s run on the garden phase's cloud in each of
    BENCH_GARDEN_MODES: its JSON, launches (the probe and sized renders,
    the chained forwards and fwd+bwd steps), drops equal to what the
    settings' caps clip, finite times. Returns {mode: JSON}."""
    t_phase = time.perf_counter()
    fwd = chain_launches(bench_garden.FWD_ITERS, bench_garden.REPS)
    fb = chain_launches(bench_garden.FWDBWD_ITERS, bench_garden.REPS)
    results = {}
    for mode in BENCH_GARDEN_MODES:
        reset_launch_counts()
        t0 = time.perf_counter()
        with checked_chains([bench_garden], f"bench_garden {mode}", True):
            res = bench_garden.run(params, state, cam, mode)
        print(json.dumps(res))
        kf, kb = ("K4", "K5") if mode == "scatter" else ("K1", "K2")
        check_tool_launches(f"bench_garden {mode}", res["launches"],
                            {kf: 2 + fwd + fb, kb: fb})
        # the JAX tool's settings drop nothing but what their caps clip:
        # the dense mode's cap of 6 tiles per Gaussian, and in --scatter
        # 4096 per tile at the settings' default 32x32 tiles
        mon = res["monitors"]
        settings = bench_garden.sized_settings(
            mode, bench_garden.probe_settings(mode), res["capacity"],
            res["packed_capacity"])
        clip = expected_drops(params, state, cam, settings,
                              mon["num_rendered"])
        dropped = mon["dropped"]
        check(dropped == clip, f"bench_garden {mode} dropped {dropped}, its "
              f"caps clip {clip}")
        check(all(math.isfinite(res[k]) and res[k] > 0
                  for k in ("fwd_ms", "fwdbwd_ms")),
              f"bench_garden {mode}: {res}")
        print(f"bench_garden {mode}: forward {res['fwd_ms']} ms, fwd+bwd "
              f"{res['fwdbwd_ms']} ms (chained eager, host clock), "
              f"dropped {dropped}, peak "
              f"{res['peak_memory_bytes'] / 2**30:.2f} GiB; "
              f"{time.perf_counter() - t0:.1f} s")
        results[mode] = res
    print(f"bench garden: the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return results


def micro_rows_ok(label: str, result: dict, count: int, no_counterpart):
    rows = result["rows"]
    check(len(rows) == count, f"{label}: {len(rows)} rows, not {count}")
    for row in rows:
        if row["name"] in no_counterpart:
            check(row["ms"] is None, f"{label}: row {row['name']} timed")
        else:
            check(row["ms"] is not None and math.isfinite(row["ms"])
                  and row["ms"] > 0, f"{label}: row {row}")


def phase_bench(tmp) -> dict:
    """The bench tools and stage timers from their ``main`` as a user runs
    them: ``bench``, ``tools.bench_suite`` (all four workloads), then
    ``exp_stage_micro`` (pallas and ``--seq``), ``exp_bwd_micro``,
    ``exp_neural_micro`` and ``exp_binning_micro`` (and its variants), all
    rows. Checks each one's launches, finite results and the suite's probe
    (no drops) and file. Returns {tool: launches}."""
    t_phase = time.perf_counter()
    launches = {}

    reset_launch_counts()
    with checked_chains([bench], "bench", True):
        res = bench.main([])
    n = chain_launches(bench.ITERS, bench.REPS)
    check_tool_launches("bench", res["launches"], {"K1": n, "K2": n})
    check(math.isfinite(res["value"]) and res["value"] > 0, f"bench {res}")
    launches["bench"] = res["launches"]

    reset_launch_counts()
    out = os.path.join(tmp, "bench_suite_results.json")
    with checked_chains([bench_suite], "bench_suite", True):
        results = bench_suite.main(["--out", out])
    with open(out) as f:
        check(json.load(f) == results, "bench_suite wrote other records")
    fb = chain_launches(bench_suite.ITERS, bench_suite.REPS)
    want = [{"K1": fb, "K2": fb}, {"K1": fb, "K2": fb}, {"K1": 1 + fb},
            {"K3": chain_launches(bench_suite.NEURAL_ITERS,
                                  bench_suite.REPS)}]
    check([r["launches"] for r in results] == want,
          f"bench_suite launched {[r['launches'] for r in results]}, "
          f"expected {want}")
    total = {}
    for r in want:
        for k, v in r.items():
            total[k] = total.get(k, 0) + v
    check_tool_launches("bench_suite", total, total)
    check(all(math.isfinite(r["value"]) and r["value"] > 0
              for r in results), f"bench_suite {results}")
    launches["bench_suite"] = total
    print(f"bench: bench and bench_suite took "
          f"{time.perf_counter() - t_phase:.1f} s")

    c8 = chain_launches(exp_stage_micro.ITERS, exp_stage_micro.REPS)
    micro = [
        ("exp_stage_micro", exp_stage_micro, [], 9, {"K4": 5 * c8,
                                                     "K5": 4 * c8}),
        ("exp_stage_micro --seq", exp_stage_micro, ["--seq"], 9,
         {"K1": 5 * c8, "K2": 4 * c8}),
        ("exp_bwd_micro", exp_bwd_micro, [], 8, {"K1": 1, "K2": 1 + c8}),
        ("exp_neural_micro", exp_neural_micro, [], 7,
         {"K3": 6 * chain_launches(exp_neural_micro.ITERS,
                                   exp_neural_micro.REPS)}),
        ("exp_binning_micro", exp_binning_micro, [], 8, {}),
        ("exp_binning_micro variants", exp_binning_micro, ["variants"], 4,
         {})]
    for label, tool, argv, count, want in micro:
        t0 = time.perf_counter()
        reset_launch_counts()
        with checked_chains([_micro, exp_neural_micro], label, False):
            res = tool.main(argv)
        check_tool_launches(label, res["launches"], want)
        micro_rows_ok(label, res, count, tool.NO_COUNTERPART)
        print(f"{label}: {count} rows, launches {res['launches'] or 'none'}"
              f"; {time.perf_counter() - t0:.1f} s")
        launches[label] = res["launches"]
    print(f"bench: the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- the parallel, multi-step, viewer and repeatability phases ------------

def state_tensors(ts) -> list:
    """Every tensor of a TrainState, in a fixed order."""
    return (list(ts.params) + list(ts.gstate)
            + [t for name in sorted(ts.opt_state)
               for t in (ts.opt_state[name].mu, ts.opt_state[name].nu)])


def max_diff(a: list, b: list) -> float:
    return max(((x.double() - y.double()).abs().max().item()
                if x.numel() else 0.0) for x, y in zip(a, b))


def phase_multistep_trainer(params, state):
    """``Trainer.step_block`` over MULTISTEP_BLOCKS blocks of
    MULTISTEP_BLOCK against as many ``Trainer.step``s, on the perturbed
    bench cloud towards its four orbit renders, white background: the
    final state must be bit-equal. Returns K1's and K2's launches in the
    block run."""
    cams, gts, _ = orbit_targets(params, state)
    iters = MULTISTEP_BLOCKS * MULTISTEP_BLOCK

    def trainer():
        model = gm.GaussianModel(SH_DEGREE)
        model.params, model.state = perturbed(params, 12), state
        model.active_sh_degree = SH_DEGREE
        return loop.Trainer(model, settings=SETTINGS, white_background=True,
                            cameras_extent=4.4)

    stepped = trainer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in range(1, iters + 1):
        stepped.step(cams[it % 4], gts[it % 4], it)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / iters

    blocked = trainer()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for blk in range(MULTISTEP_BLOCKS):
        first = blk * MULTISTEP_BLOCK + 1
        idx = [it % 4 for it in range(first, first + MULTISTEP_BLOCK)]
        metrics = blocked.step_block(
            stack_cameras([cams[i] for i in idx]),
            torch.stack([gts[i] for i in idx]), first)
    torch.cuda.synchronize()
    block_ms = (time.perf_counter() - t0) * 1e3 / iters
    counts = launch_counts()
    check(counts["K1"] == iters and counts["K2"] == iters,
          f"{iters} block iterations launched {counts}")
    check(blocked.ts.step == stepped.ts.step == iters,
          f"steps {blocked.ts.step} / {stepped.ts.step}")
    a, b = state_tensors(blocked.ts), state_tensors(stepped.ts)
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    check(equal, f"step_block's state differs from the steps' by max |d| "
          f"{max_diff(a, b)}")
    check(math.isfinite(metrics["loss"].item()), "block loss not finite")
    print(f"multistep trainer: {MULTISTEP_BLOCKS} blocks of "
          f"{MULTISTEP_BLOCK} bit-equal to {iters} Trainer.steps; "
          f"{block_ms:.3f} ms per iteration in blocks, {step_ms:.3f} ms "
          f"stepped (host clock, synchronised at the ends); K1 "
          f"{counts['K1']}, K2 {counts['K2']} launches")
    return counts["K1"], counts["K2"]


def phase_multistep_entry(tmp, src, ply_sha):
    """The train entry point with ``--steps_per_call`` MULTISTEP_SPC over
    the scene phase's dataset for SCENE_ITERS iterations, evaluated at the
    end only so the blocks tile the run: its saved PLY must be bit-equal
    to the ``--steps_per_call 1`` run's (``ply_sha``). Returns K1's and
    K2's launches."""
    out = os.path.join(tmp, "out_spc")
    torch.cuda.synchronize()
    reset_launch_counts()
    summary = train_entry.main(
        ["-s", src, "-m", out, "--iterations", str(SCENE_ITERS),
         "--test_iterations", str(SCENE_ITERS), "--save_iterations",
         str(SCENE_ITERS), "--steps_per_call", str(MULTISTEP_SPC),
         "--quiet"] + SCENE_TRAIN_ARGS)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["K2"] == SCENE_ITERS and counts["K1"] >= SCENE_ITERS,
          f"--steps_per_call {MULTISTEP_SPC}: {counts}")
    sha = file_sha(os.path.join(out, SCENE_FILES[0]))
    check(sha == ply_sha, f"--steps_per_call {MULTISTEP_SPC} saved a PLY "
          f"unlike the --steps_per_call 1 run's")
    psnr = summary["evals"][SCENE_ITERS]["test"][1]
    print(f"multistep entry: --steps_per_call {MULTISTEP_SPC}, "
          f"{SCENE_ITERS} iterations in {summary['wall_s']:.2f} s, median "
          f"{summary['median_iter_ms']:.3f} ms per iteration (host clock, "
          f"per block); the saved PLY bit-equal to --steps_per_call 1's; "
          f"test PSNR {psnr:.3f}; K1 {counts['K1']}, K2 {counts['K2']} "
          f"launches")
    return counts["K1"], counts["K2"]


def file_sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def sequential_stats(params, state, cams, gts, bg, settings):
    """The densification statistics of one single-camera iteration per
    camera, accumulated in turn (what a DP batch must equal)."""
    stats = state
    n = params.xyz.shape[0]
    for cam, gt in zip(cams, gts):
        off = params.xyz.new_zeros((n, 2), requires_grad=True)
        out = render(cam, params, state.alive, SH_DEGREE, bg, settings,
                     means2d_offset=off)
        loss = losses.photometric_loss(out["render"], gt, 0.2)
        goff, = torch.autograd.grad(loss, [off])
        stats = dens.add_densification_stats(stats, out["radii"], goff)
    return stats


def phase_dp(params, state, mesh):
    """``DPTrainer`` on a world of one NCCL rank, batch DP_BATCH at the
    bench width: one step's statistics against DP_BATCH single-camera
    iterations (denom exact; the gradient accumulator at JAX's rtol 1e-4 /
    atol 1e-7), then DP_STEPS steps from the perturbed cloud (finite, loss
    falling). Returns K1's and K2's launches in the DP_STEPS steps."""
    cams, gts, bg = orbit_targets(params, state)
    cams, gts = cams[:DP_BATCH], gts[:DP_BATCH]
    start = perturbed(params, 12)
    tx = optim.make_optimizer(optim.OptimizationParams(), 1.0)
    ts = loop.TrainState(start, state, tx.init(start), 0)
    step = make_dp_train_step(mesh, tx, sh_degree=SH_DEGREE,
                              settings=SETTINGS)
    batch = stack_cameras(cams)
    ts1, _ = step(ts, batch, torch.stack(gts), bg)
    want = sequential_stats(start, state, cams, gts, bg, SETTINGS)
    check(torch.equal(ts1.gstate.denom, want.denom),
          "DP denom differs from the sequential iterations'")
    got, ref = ts1.gstate.xyz_gradient_accum, want.xyz_gradient_accum
    close = torch.allclose(got, ref, rtol=1e-4, atol=1e-7)
    check(close, f"DP gradient accumulator off by max |d| "
          f"{(got - ref).abs().max().item()}")
    check(torch.equal(ts1.gstate.max_radii2d, want.max_radii2d),
          "DP max radii differ")

    model = gm.GaussianModel(SH_DEGREE)
    model.params, model.state = start, state
    model.active_sh_degree = SH_DEGREE
    trainer = DPTrainer(model, mesh, settings=SETTINGS, batch_size=DP_BATCH,
                        cameras_extent=4.4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    loss, ms = [], []
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        loss.append(trainer.step(cams, gts)["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(counts["K1"] == counts["K2"] == DP_STEPS * DP_BATCH,
          f"{DP_STEPS} DP steps of {DP_BATCH} launched {counts}")
    check(all(math.isfinite(x) for x in loss), f"DP loss {loss}")
    check(loss[-1] < loss[0], f"DP loss did not fall: {loss}")
    for name, t in trainer.ts.params._asdict().items():
        check(torch.isfinite(t).all().item(), f"DP {name} not finite")
    print(f"dp: NCCL world {mesh_lib.world_size()}, batch {DP_BATCH}; "
          f"stats of one step equal {DP_BATCH} sequential iterations "
          f"(denom exact, accumulator max |d| "
          f"{(got - ref).abs().max().item():.3e}); {DP_STEPS} steps loss "
          f"{loss[0]:.5f} -> {loss[-1]:.5f}, median "
          f"{statistics.median(ms[1:]):.3f} ms per step (host clock, "
          f"synchronised by the loss read); peak memory {peak:.2f} GiB; K1 "
          f"{counts['K1']}, K2 {counts['K2']} launches")
    return counts["K1"], counts["K2"]


def strip_rounding(params, state, cam, n_strips):
    """How the strip cameras' float32 projection rows move the Gaussians'
    preprocess, over the Gaussians that a strip and the frame both keep:
    (the largest gap between a pixel row in a strip, plus the strip's
    first row, and in the frame, in ulps of the frame's height (float32);
    {output: max |d|} of every other output (x, depth, radius, conic,
    opacity, colour) that is not bit-equal in some strip)."""
    def pre(c):
        return pp.preprocess_gaussians(
            params.xyz, gm.get_scaling(params), gm.get_rotation(params),
            gm.get_opacity(params, state.alive), gm.get_features(params),
            SH_DEGREE, c, SETTINGS.block_x, SETTINGS.block_y,
            tight=SETTINGS.tight_culling)

    full = pre(cam)
    strips = strip_cameras(cam, n_strips)
    h = torch.tensor(float(cam.height))
    unit = (torch.nextafter(h, torch.tensor(math.inf)) - h).item()
    worst, apart = 0.0, {}
    for s in range(n_strips):
        part = pre(strips.camera(s))
        # a Gaussian away from the strip is culled there, as it should be
        vis = (full.radii > 0) & (part.radii > 0)
        gap = part.means2d[vis, 1] + s * strips.height - full.means2d[vis, 1]
        worst = max(worst, gap.abs().max().item() / unit)
        for k in ("depths", "radii", "conic", "opacity", "rgb", "means2d"):
            a, b = getattr(part, k)[vis], getattr(full, k)[vis]
            if k == "means2d":
                a, b = a[:, 0], b[:, 0]
            if not torch.equal(a, b):
                apart[k] = max(apart.get(k, 0.0),
                               (a.double() - b.double()).abs().max().item())
    return worst, apart


def phase_sp(params, state, mesh):
    """The 800x800 frame in SP_STRIPS strips through
    ``make_sharded_renderer`` on the mesh against the monolithic render.
    A strip camera is JAX's asymmetric frustum, whose float32 projection
    row rounds each Gaussian's pixel row apart from the frame's by an ulp
    or two, so the gates are: every preprocess output but that row
    bit-equal and the row within SP_ULPS ulps of H; binning alike (the
    strips' instances add up to the frame's); the image bit-equal, else
    within BAND_GATE (the repo's gate for two renders that differ by
    design) with its differences printed. Returns K1's launches per frame."""
    cam = demo.demo_camera(W, H)
    bg = torch.zeros(3, device="cuda")
    renderer = make_sharded_renderer(mesh, sh_degree=SH_DEGREE,
                                     settings=SETTINGS, n_strips=SP_STRIPS)
    with torch.no_grad():
        worst, apart = strip_rounding(params, state, cam, SP_STRIPS)
        check(not apart, f"a strip camera changed preprocess outputs "
              f"other than the pixel row (max |d|): {apart}")
        check(worst <= SP_ULPS, f"a strip's pixel rows lie {worst} ulps "
              f"of the frame height from the frame's")
        mono = render(cam, params, state.alive, SH_DEGREE, bg,
                      SETTINGS)["render"]
        torch.cuda.synchronize()
        reset_launch_counts()
        frame = renderer(cam, params, state.alive, bg)
        torch.cuda.synchronize()
        launches = blend_seq.launches
        check(launches == SP_STRIPS,
              f"a {SP_STRIPS}-strip frame launched K1 {launches} times")
        check(frame.shape == mono.shape, f"frame {tuple(frame.shape)}")
        strips = strip_cameras(cam, SP_STRIPS)
        counts = [int(render(strips.camera(i), params, state.alive,
                             SH_DEGREE, bg, SETTINGS)["num_rendered"])
                  for i in range(SP_STRIPS)]
        whole = int(render(cam, params, state.alive, SH_DEGREE, bg,
                           SETTINGS)["num_rendered"])
        check(sum(counts) == whole, f"strip instances {counts} (sum "
              f"{sum(counts)}) against the frame's {whole}")
        diff = (frame - mono).abs()
        if torch.equal(frame, mono):
            verdict = "bit-equal to the monolithic render"
        else:
            check(diff.max().item() <= BAND_GATE[0]
                  and diff.mean().item() <= BAND_GATE[1],
                  f"the strip frame differs from the monolithic render by "
                  f"max |d| {diff.max().item()}, mean "
                  f"{diff.mean().item()}")
            verdict = (f"not bit-equal: {int((diff > 0).sum())} of "
                       f"{diff.numel()} values differ, "
                       f"{int((diff > SP_ATOL).sum())} by more than JAX's "
                       f"atol {SP_ATOL}; max |d| {diff.max().item():.3e}, "
                       f"mean {diff.mean().item():.3e} (the strip rows' "
                       f"rounding, at most {worst:.2f} ulps of the frame "
                       f"height, moves each blend)")

        def timed(fn, reps=10):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / reps

        frame_ms = timed(lambda: renderer(cam, params, state.alive, bg))
        mono_ms = timed(lambda: render(cam, params, state.alive, SH_DEGREE,
                                       bg, SETTINGS))
    print(f"sp: {SP_STRIPS} strips of {H // SP_STRIPS} rows through "
          f"make_sharded_renderer (NCCL world {mesh_lib.world_size()}), "
          f"{verdict}; preprocess bit-equal but for the pixel rows; "
          f"instances {counts} add up to the frame's {whole}; K1 "
          f"{launches} launches per frame; frame {frame_ms:.3f} ms, "
          f"monolithic render {mono_ms:.3f} ms (host clock, mean of 10, "
          f"synchronised)")
    return launches


def viewer_message(cam, train: bool) -> bytes:
    """A SIBR remote-viewer request for ``cam``'s view: the transposed
    storage with the view's columns 1, 2 and the projection's column 1
    negated, as ``network_gui.receive`` undoes."""
    view = cam.view.cpu().numpy().T.copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    fp = cam.full_proj.cpu().numpy().T.copy()
    fp[:, 1] *= -1
    msg = {"resolution_x": cam.width, "resolution_y": cam.height,
           "train": train, "fov_x": 2 * math.atan(cam.tan_fovx),
           "fov_y": 2 * math.atan(cam.tan_fovy), "z_near": 0.01,
           "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
           "keep_alive": True, "scaling_modifier": 1.0,
           "view_matrix": view.reshape(-1).tolist(),
           "view_projection_matrix": fp.reshape(-1).tolist()}
    payload = json.dumps(msg).encode()
    return len(payload).to_bytes(4, "little") + payload


def parsed_camera(wire: bytes):
    """The camera ``NetworkGUI.receive`` makes of a request."""
    gui = network_gui.NetworkGUI("127.0.0.1", 0)
    peer, gui.conn = socket.socketpair()
    try:
        peer.sendall(wire)
        return gui.receive()[0]
    finally:
        peer.close()
        gui.close()


def viewer_client(port: int, cams, got: dict):
    """Connect to the entry point's viewer, ask for one frame per camera
    (training held for the first, handed back with the last) and keep the
    bytes received."""
    deadline = time.monotonic() + 120
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=120)
            break
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.01)
    with sock:
        for i, cam in enumerate(cams):
            sock.sendall(viewer_message(cam, train=i == len(cams) - 1))
            size = cam.width * cam.height * 3
            buf = b""
            while len(buf) < size + 4:
                chunk = sock.recv(size + 4 - len(buf))
                if not chunk:
                    raise ConnectionError("the entry point closed")
                buf += chunk
            n = int.from_bytes(buf[size:], "little")
            path = b""
            while len(path) < n:
                path += sock.recv(n - len(path))
            got.setdefault("frames", []).append(buf[:size])
            got.setdefault("paths", []).append(path.decode("ascii"))


def phase_viewer(tmp, src, out):
    """The train entry point serving the SIBR viewer on a free loopback
    port, resumed from the scene phase's checkpoint for VIEWER_ITERS
    iterations; a client thread asks for two 800x800 frames (training held
    for the first, handed back with the second) and closes. The entry's
    first accept waits for the client, so both frames show the
    checkpoint's state: each must be byte-equal to ``render_to_bytes`` of a
    direct render of the camera ``receive`` makes of its request. Returns
    K1's launches."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ckpt = os.path.join(out, f"chkpnt{SCENE_CHECKPOINT}.ckpt")
    cams = [demo.demo_camera(W, H, a) for a in (0.3, 2.1)]
    got = {}
    client = threading.Thread(target=viewer_client,
                              args=(port, cams, got), daemon=True)
    accept = network_gui.NetworkGUI.try_connect

    def first_accept_waits(gui):
        gui.listener.settimeout(120)
        try:
            accept(gui)
        finally:
            gui.listener.settimeout(0)
            network_gui.NetworkGUI.try_connect = accept

    network_gui.NetworkGUI.try_connect = first_accept_waits
    client.start()
    torch.cuda.synchronize()
    reset_launch_counts()
    try:
        summary = train_entry.main(
            ["-s", src, "-m", os.path.join(tmp, "out_viewer"),
             "--start_checkpoint", ckpt, "--iterations",
             str(SCENE_CHECKPOINT + VIEWER_ITERS), "--port", str(port),
             "--quiet"] + [a for a in SCENE_TRAIN_ARGS
                           if a != "--disable_viewer"])
    finally:
        network_gui.NetworkGUI.try_connect = accept
    torch.cuda.synchronize()
    client.join(timeout=120)
    check(not client.is_alive(), "the viewer client did not finish")
    launches = blend_seq.launches
    check(summary["viewer"] == [SCENE_CHECKPOINT + 1] * len(cams),
          f"viewer frames served at {summary['viewer']}")
    check(got.get("paths") == [src] * len(cams),
          f"viewer source paths {got.get('paths')}")
    check(launches == VIEWER_ITERS + len(cams),
          f"{VIEWER_ITERS} iterations and {len(cams)} frames launched K1 "
          f"{launches} times")

    payload = torch.load(ckpt, map_location="cuda", weights_only=True)
    ckpt_params = gm.normalize_params(gm.GaussianParams(**payload["params"]))
    alive = payload["gstate"]["alive"]
    settings = train_entry.pipeline_settings(
        train_entry.build_parser().parse_args(["-s", src]))
    for cam, frame in zip(cams, got["frames"]):
        cam = parsed_camera(viewer_message(cam, train=True))
        with torch.no_grad():
            want = render(cam, ckpt_params, alive,
                          payload["active_sh_degree"],
                          torch.zeros(3, device="cuda"), settings)["render"]
        check(bytes(network_gui.render_to_bytes(want)) == frame,
              "a viewer frame differs from the direct render of its camera")
    check(math.isfinite(summary["last_loss"]), "viewer run: loss")
    print(f"viewer: the entry point served {len(cams)} {W}x{H} frames at "
          f"iteration {SCENE_CHECKPOINT + 1}, each byte-equal to a direct "
          f"render; then {VIEWER_ITERS} iterations in "
          f"{summary['wall_s']:.2f} s; K1 {launches} launches")
    return launches


def neural_runs(params, state, cams, gts, steps):
    """A fresh ``NeuralTrainer(sw=2)`` from the seeded decoders, ``steps``
    steps over ``cams`` in turn: (losses, decoder and feature tensors,
    synchronised per-step ms)."""
    model = gm.GaussianModel(NEURAL_SH)
    model.params, model.state = params, state
    trainer = neural_loop.NeuralTrainer(model, sw=2, capacity=TILE_CAPACITY)
    loss, ms = [], []
    for s in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss.append(trainer.step(cams[s % len(cams)], gts[s % len(cams)])
                    ["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    leaves = dict(neural_loop.decoder_leaves(trainer.ts.net_params),
                  features=trainer.ts.params.features)
    return (torch.stack(loss),
            {k: v.detach().clone() for k, v in leaves.items()}, ms)


def same_run(a, b) -> bool:
    return torch.equal(a[0], b[0]) and all(
        torch.equal(a[1][k], b[1][k]) for k in a[1])


def phase_neural_repeat(params, state):
    """Neural runs repeat to the bit: two ``NeuralTrainer(sw=2)`` runs of
    NEURAL_REPEAT_SHORT steps from the same seed, then two of
    NEURAL_REPEAT_LONG steps over eight orbit cameras with the caching
    allocator's state changed between them, must give bit-equal losses,
    decoders and features. Between the long pinned runs run two with the
    step unpinned (cuDNN's default algorithm choice, patched in here; the
    denoiser's kernels add in one order either way): their step time is
    the pin's cost, and whether they repeat is printed. Returns K3's
    launches in the pinned runs."""
    cams = [demo.demo_camera(W, H, 2 * math.pi * i / 8) for i in range(8)]
    with torch.no_grad():
        gts = [render(c, params, state.alive, NEURAL_SH,
                      torch.zeros(3, device="cuda"), SETTINGS)["render"]
               for c in cams]
    torch.cuda.synchronize()
    zbuffer_pallas.launches = 0
    short = [neural_runs(params, state, cams[:1], gts[:1],
                         NEURAL_REPEAT_SHORT) for _ in range(2)]
    check(same_run(*short), f"two {NEURAL_REPEAT_SHORT}-step neural runs "
          f"differ")
    pinned = [neural_runs(params, state, cams, gts, NEURAL_REPEAT_LONG)]
    launches = zbuffer_pallas.launches
    check(launches == 2 * NEURAL_REPEAT_SHORT + NEURAL_REPEAT_LONG,
          f"the repeat runs launched K3 {launches} times")
    big = torch.empty(20 << 30, dtype=torch.uint8, device="cuda")
    del big
    saved = neural_loop.deterministic_cudnn
    neural_loop.deterministic_cudnn = contextlib.nullcontext
    try:
        unpinned = [neural_runs(params, state, cams, gts, NEURAL_REPEAT_LONG)
                    for _ in range(2)]
    finally:
        neural_loop.deterministic_cudnn = saved
    zbuffer_pallas.launches = 0
    pinned.append(neural_runs(params, state, cams, gts, NEURAL_REPEAT_LONG))
    launches += zbuffer_pallas.launches
    check(same_run(*pinned), f"two {NEURAL_REPEAT_LONG}-step neural runs "
          f"differ: " + ", ".join(
              k for k in pinned[0][1]
              if not torch.equal(pinned[0][1][k], pinned[1][1][k])))
    ms_pinned = statistics.median(pinned[0][2][2:] + pinned[1][2][2:])
    ms_unpinned = statistics.median(unpinned[0][2][2:]
                                    + unpinned[1][2][2:])
    differ = [k for k in unpinned[0][1]
              if not torch.equal(unpinned[0][1][k], unpinned[1][1][k])]
    print(f"neural repeat: NeuralTrainer(sw=2) at {W}x{H}/{N // 1000}k, "
          f"2 x {NEURAL_REPEAT_SHORT} steps and 2 x {NEURAL_REPEAT_LONG} "
          f"steps over 8 views bit-equal (losses, decoders, features); "
          f"median step {ms_pinned:.3f} ms pinned, {ms_unpinned:.3f} ms "
          f"unpinned (host clock, synchronised, runs in the order pinned, "
          f"unpinned, unpinned, pinned); the unpinned pair "
          + (f"differs in {len(differ)} tensors ({', '.join(differ[:4])})"
             if differ or not torch.equal(unpinned[0][0], unpinned[1][0])
             else "repeated this time")
          + f"; K3 {launches} launches")
    return launches


@contextlib.contextmanager
def harness_output(label: str):
    """Hold a harness's own printing (its entry point's progress lines,
    its JSON) back; print its tail if the harness raises."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield
    except BaseException:
        print(f"{label} output (tail):\n{buf.getvalue()[-4000:]}")
        raise


def quality_counts() -> dict:
    torch.cuda.synchronize()
    counts = launch_counts()
    counts["K3"] = zbuffer_pallas.launches
    return counts


def gate_published(label: str, rows: list, published: dict):
    """Each published row's test PSNR, less QUALITY_MARGIN, held against
    the port's row at that iteration."""
    got = {r["iteration"]: r["psnr"] for r in rows}
    for it, want in published.items():
        check(it in got, f"{label}: no evaluation at {it}")
        check(got[it] >= want - QUALITY_MARGIN,
              f"{label}: test PSNR {got[it]:.3f} dB at {it}, more than "
              f"{QUALITY_MARGIN} dB below the JAX package's {want}")


def phase_quality(tmp) -> dict:
    """The full-schedule harnesses at full width, cut in depth: (a) the
    quality proof's scene trained QUALITY_ITERS iterations through
    ``train_quality_proof``'s ``main`` (SH warm-up to degree 3, ~25
    densify steps, capacity growth, the opacity reset at 3000); (b) the
    oracle's ``hold`` on it; (c) ``train_neural_quality`` from (a)'s PLY;
    (d) the garden scene through ``train_garden``; (e)
    ``bench_trained_scene`` on (a)'s model. Returns the launches of each
    part per kernel."""
    launches = {}
    scene = os.path.join(tmp, "q_scene")
    proof_out = os.path.join(tmp, "q_proof")

    argv = ["--scene", scene, "--out", proof_out, "--iters",
            str(QUALITY_ITERS)]
    t0 = time.perf_counter()
    gen_s = train_quality_proof.generate(
        train_quality_proof.build_parser().parse_args(argv))
    reset_launch_counts()
    with harness_output("quality proof"):
        proof = train_quality_proof.main(argv)
    counts = quality_counts()
    part_s = time.perf_counter() - t0
    rows, data = proof["test_psnr"], proof["dataset"]
    evals = len(rows) * (data["test_views"] + 5)
    check(counts["K1"] == QUALITY_ITERS + evals
          and counts["K2"] == QUALITY_ITERS,
          f"quality proof: {QUALITY_ITERS} iterations and {evals} "
          f"evaluation renders launched {counts}")
    check(proof["launches"] == {"K1": counts["K1"], "K2": counts["K2"]},
          f"quality proof: the harness counted {proof['launches']}")
    gate_published("quality proof", rows, QUALITY_PUBLISHED)
    check(proof["capacity"] >= 2 * data["init_points"],
          f"quality proof: capacity {proof['capacity']}: maybe_grow never "
          f"fired")
    check(proof["tune_drops"] and all(d == 0 for _, d in
                                      proof["tune_drops"]),
          f"quality proof: drops at the tune points {proof['tune_drops']}")
    launches["proof"] = counts
    print(f"quality proof: {QUALITY_ITERS} iterations ({data['resolution']}x"
          f"{data['resolution']}, {data['train_views']} train / {data['test_views']} test "
          f"views, {data['gt_gaussians']} GT, {data['init_points']} init) "
          f"in {part_s:.2f} s (scene "
          f"written in {gen_s:.2f} s, set-up {proof['setup_s']:.2f} s, "
          f"training {proof['wall_clock_s'] - proof['setup_s']:.2f} s), "
          f"median iteration {proof['median_iter_ms']:.3f} ms (host "
          f"clock); test PSNR "
          + ", ".join(f"{r['iteration']}: {r['psnr']:.3f} dB (L1 "
                      f"{r['l1']:.5f})" for r in rows)
          + f" against the JAX package's {QUALITY_PUBLISHED}; alive "
          f"{data['init_points']} -> {proof['alive']}, capacity "
          f"{proof['capacity']}; drops at the tune points "
          f"{proof['tune_drops']}; peak "
          f"{proof['peak_memory_bytes'] / 2**30:.3f} GiB; K1 "
          f"{counts['K1']}, K2 {counts['K2']} launches")

    t0 = time.perf_counter()
    reset_launch_counts()
    with harness_output("oracle"):
        hold = exp_quality_oracle.main(["hold", "--scene", scene, "--iters",
                                        str(ORACLE_ITERS)])["hold"]
    counts = quality_counts()
    part_s = time.perf_counter() - t0
    check([r["iteration"] for r in hold] == [0, ORACLE_ITERS],
          f"oracle rows {hold}")
    check(all(r["psnr"] >= ORACLE_PSNR for r in hold),
          f"oracle hold: test PSNR {[r['psnr'] for r in hold]} below "
          f"{ORACLE_PSNR} dB")
    check(counts["K1"] == ORACLE_ITERS + 8 * len(hold) and counts["K2"]
          == ORACLE_ITERS, f"oracle hold launched {counts}")
    launches["oracle"] = counts
    print(f"quality oracle: hold {ORACLE_ITERS} iterations in "
          f"{part_s:.2f} s; test PSNR "
          + ", ".join(f"{r['iteration']}: {r['psnr']:.3f} dB" for r in hold)
          + f"; alive {hold[-1]['alive']}; K1 {counts['K1']}, K2 "
          f"{counts['K2']} launches")

    ply = os.path.join(proof_out, "point_cloud",
                       f"iteration_{QUALITY_ITERS}", "point_cloud.ply")
    t0 = time.perf_counter()
    reset_launch_counts()
    with harness_output("neural quality"):
        neural = train_neural_quality.main([
            "--scene", scene, "--out", os.path.join(tmp, "q_neural"),
            "--iters", str(NEURAL_QUALITY_ITERS), "--start_ply", ply])
    counts = quality_counts()
    part_s = time.perf_counter() - t0
    nrows = neural["milestones"]
    psnrs = [r["psnr"] for r in nrows]
    check(len(psnrs) >= 2 and all(math.isfinite(p) for p in psnrs)
          and psnrs[-1] > psnrs[0],
          f"neural quality: test PSNR {psnrs} not finite and rising")
    check(counts["K3"] >= NEURAL_QUALITY_ITERS,
          f"neural quality: {NEURAL_QUALITY_ITERS} iterations launched "
          f"{counts}")
    launches["neural"] = counts
    print(f"quality neural: --sw 2, {NEURAL_QUALITY_ITERS} iterations from "
          f"the proof's PLY in {part_s:.2f} s (set-up "
          f"{neural['setup_s']:.2f} s), median iteration "
          f"{neural['median_iter_ms']:.3f} ms; test PSNR "
          + ", ".join(f"{r['iteration']}: {r['psnr']:.3f} dB" for r in nrows)
          + f"; peak {neural['peak_memory_bytes'] / 2**30:.3f} GiB; K3 "
          f"{counts['K3']} launches")

    garden_scene = os.path.join(tmp, "garden_scene")
    argv = ["--scene", garden_scene, "--out", os.path.join(tmp, "garden_out"),
            "--iters", str(GARDEN_ITERS)]
    t0 = time.perf_counter()
    gen_s = train_garden.generate(train_garden.build_parser().parse_args(
        argv))
    pts = ply_io.fetch_point_cloud(
        os.path.join(garden_scene, "points3d.ply"))[0]
    t1 = time.perf_counter()
    knn.mean_sq_dist_3nn(pts)
    knn_s = time.perf_counter() - t1
    reset_launch_counts()
    with harness_output("garden"):
        garden = train_garden.main(argv)
    counts = quality_counts()
    part_s = time.perf_counter() - t0
    grows = garden["milestones"]
    gate_published("garden", grows, GARDEN_PUBLISHED)
    check(math.isfinite(garden["last_loss"])
          and all(math.isfinite(r["l1"]) for r in grows),
          f"garden: losses {garden['last_loss']}, {grows}")
    check(counts["K1"] >= GARDEN_ITERS and counts["K2"] == GARDEN_ITERS,
          f"garden: {GARDEN_ITERS} iterations launched {counts}")
    launches["garden"] = counts
    print(f"quality garden: {GARDEN_ITERS} iterations "
          f"({garden['scene']['resolution']}, {garden['scene']['views']} "
          f"train views, {garden['scene']['gt_gaussians']} GT, {len(pts)} "
          f"init points) in {part_s:.2f} s "
          f"(scene written in {gen_s:.2f} s; set-up {garden['setup_s']:.2f} "
          f"s; the init cloud's kNN "
          f"{'(native) ' if native.available() else '(Python) '}{knn_s:.2f} "
          f"s timed alone), median iteration "
          f"{garden['median_iter_ms']:.3f} ms, {garden['iters_per_s']:.3f} "
          f"iterations/s; test PSNR "
          + ", ".join(f"{r['iteration']}: {r['psnr']:.3f} dB (L1 "
                      f"{r['l1']:.5f})" for r in grows)
          + f" against the JAX package's {GARDEN_PUBLISHED}; "
          f"{garden['final_alive_line']}; drops at the tune points "
          f"{garden['tune_drops']}; peak "
          f"{garden['peak_memory_bytes'] / 2**30:.3f} GiB; last loss "
          f"{garden['last_loss']:.6f}; K1 {counts['K1']}, K2 "
          f"{counts['K2']} launches")

    t0 = time.perf_counter()
    reset_launch_counts()
    with harness_output("trained-scene bench"):
        bench = bench_trained_scene.main(["-m", proof_out])
    counts = quality_counts()
    part_s = time.perf_counter() - t0
    check(bench["dropped"] == 0,
          f"trained-scene bench: the probe dropped {bench['dropped']}")
    check(counts["K1"] > 0 and counts["K2"] > 0,
          f"trained-scene bench launched {counts}")
    launches["bench"] = counts
    print(f"quality bench: the proof's model ({bench['n_alive']} alive) at "
          f"{bench['resolution']} in {part_s:.2f} s: fwd_ms "
          f"{bench['fwd_ms']:.4f}, fwd_fps {bench['fwd_fps']:.2f}, "
          f"fwdbwd_ms {bench['fwdbwd_ms']:.4f}, num_rendered "
          f"{bench['num_rendered']}, capacity {bench['capacity']}, "
          f"packed_capacity {bench['packed_capacity']}, dropped 0; K1 "
          f"{counts['K1']}, K2 {counts['K2']} launches")
    print(f"quality card: {card_line()}")
    return launches


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
    rows = phase_preprocess(params, state)
    rows["adam_update"] = phase_adam()
    rows.update(phase_denoise())
    rows.update(phase_binning())
    rows.update(K1=phase_k1_parity(params, state),
                K2=phase_k2_parity(params, state))
    phase_small_reference()
    loaded, lstate = phase_serve(params, state, rows)
    phase_breakdown(loaded, lstate)
    phase_train(loaded, lstate, rows)
    phase_trainer()
    rows["K1"]["multistep_launches"], rows["K2"]["multistep_launches"] = \
        phase_multistep_trainer(params, state)
    with tempfile.TemporaryDirectory() as store:
        distributed.initialize(init_method=f"file://{store}/store",
                               world_size=1, rank=0,
                               device=torch.device("cuda", 0))
        try:
            mesh = distributed.make_global_mesh(n_tile=1)
            rows["K1"]["dp_launches"], rows["K2"]["dp_launches"] = phase_dp(
                params, state, mesh)
            rows["K1"]["sp_launches"] = phase_sp(params, state, mesh)
        finally:
            dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        src, out, run_psnr, ply_sha = phase_scene(tmp, rows)
        (rows["K1"]["multistep_entry_launches"],
         rows["K2"]["multistep_entry_launches"]) = phase_multistep_entry(
            tmp, src, ply_sha)
        rows["K1"]["viewer_launches"] = phase_viewer(tmp, src, out)
        offline = phase_offline(tmp, src, out, run_psnr)

    pallas = phase_pallas_serve(params, state)
    pallas_32, _ = sized_settings(PALLAS_PROBE_32, params, state.alive,
                                  demo.demo_camera(W, H))
    rows.update(phase_k4_k5_parity(params, state, pallas, pallas_32))
    rows["K4"]["launches"], rows["K5"]["launches"] = phase_pallas_train(
        params, state)
    garden, cloud = phase_garden()
    for name in ("K1", "K2", "K4", "K5"):
        rows[name]["garden"] = garden[name]
    bench_launches = {
        f"bench_garden {mode}": res["launches"]
        for mode, res in phase_bench_garden(*cloud).items()}
    del cloud
    torch.cuda.empty_cache()

    nparams, nstate = neural_scene()
    rows["K3"] = phase_k3_parity(nparams, nstate)
    phase_small_neural_reference()
    phase_neural_serve(nparams, nstate)
    phase_neural_train(nparams, nstate, rows)
    rows["K3"]["repeat_launches"] = phase_neural_repeat(nparams, nstate)
    del nparams, nstate
    torch.cuda.empty_cache()

    rows["K6"] = phase_k6()
    rows["K7"] = phase_k7()
    rows["K6"]["launches"], rows["K7"]["launches"], decoded = phase_tools()
    # the decode tool's chained times beside the phase's per-launch ones
    for entry, result in zip(rows["K6"]["workloads"], decoded):
        check(entry["workload"] == result["name"], "decode tool workloads")
        entry.update(chained_ms=result["k6_ms"],
                     chained_plain_ms=result["plain_ms"],
                     chained_library_ms=result["repeat_interleave_ms"])

    with tempfile.TemporaryDirectory() as tmp:
        bench_launches.update(phase_bench(tmp))
    for name in rows:
        used = {tool: counts[name] for tool, counts in bench_launches.items()
                if counts.get(name)}
        if used:
            rows[name]["bench_launches"] = used

    with tempfile.TemporaryDirectory() as tmp:
        quality = phase_quality(tmp)
    for name in ("K1", "K2", "K3"):
        rows[name]["quality_launches"] = {
            part: counts[name] for part, counts in quality.items()
            if counts[name]}

    rows["K1"]["render_entry_launches"] = offline["K1"]
    rows["K4"]["render_entry_launches"] = offline["K4"]
    rows["K3"]["trainn_launches"] = offline["K3"]
    print(json.dumps({"kernels": [rows[k] for k in sorted(rows)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
