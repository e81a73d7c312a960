"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the forward render path from csrc/, holds each
against its plain PyTorch version at the shapes of the bench workload
(800x800, 100k Gaussians, SH degree 3, the bench rasterizer settings), then
serves the path as a user would: a demo cloud saved to PLY, loaded back and
rendered from four cameras through ``gaussian_renderer.render``, checking
that every render went through the kernels. It prints one JSON line of
per-kernel numbers, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line. Needs a CUDA device and nvcc (CUDA_HOME or /usr/local/cuda);
imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import blend_pallas
from neuralgaussiansplatting_torch.ops import blend_seq
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import rasterize as rast

W = H = 800
N = 100_000
SH_DEGREE = 3
SETTINGS = rast.make_settings(
    "seq", capacity=512 * 1024, packed_capacity=512 * 1024,
    max_per_tile=4096, fast_sort=True, tight_culling=True, precise_cull=True)
VIEWS = (0.0, 0.5 * math.pi, math.pi, 1.5 * math.pi)   # about the y axis
ATOL = 5e-5            # color / final T, the JAX seq kernel's own gate
CONTRIB_AGREE = 0.999  # n_contrib equal on at least this share of pixels
# H100 SXM data sheet peaks (dense, no sparsity), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per visited (instance, pixel) pair of the blend, expf as
# one: 2 sub (dx, dy), 6 mul + 1 add + 1 mul + 1 sub (power), expf, 1 mul +
# 1 min (alpha), 1 mul + 1 sub (T), 3 mul + 3 add (color); the comparisons
# and selects are not counted.
K1_OPS_PER_PAIR = 22


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


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k1_inputs(params, state, cam, mark=lambda stage: None):
    """Preprocess -> bin -> pack as ``rasterize`` runs them for one view:
    the inputs K1 sees on the main path. ``mark(stage)`` is called after
    each stage."""
    tiles_x, tiles_y = SETTINGS.tiles_for(cam.width, cam.height)
    pre = pp.preprocess_gaussians(
        params.xyz, gm.get_scaling(params), gm.get_rotation(params),
        gm.get_opacity(params, state.alive), gm.get_features(params),
        SH_DEGREE, cam, SETTINGS.block_x, SETTINGS.block_y,
        tight=SETTINGS.tight_culling)
    mark("preprocess")
    inst = binning.bin_gaussians(
        pre, tiles_x, tiles_y, SETTINGS.capacity, SETTINGS.max_per_tile,
        SETTINGS.chunk, pack_keys=SETTINGS.fast_sort,
        packed_capacity=SETTINGS.packed_capacity,
        precise_cull=SETTINGS.precise_cull, block_x=SETTINGS.block_x,
        block_y=SETTINGS.block_y, width=cam.width, height=cam.height)
    mark("bin")
    packed = blend_pallas.pack_gather(blend_pallas.pack_instance_attrs_t(
        pre.means2d, pre.conic, pre.opacity, pre.rgb), inst.gid)
    mark("pack")
    return packed, inst, tiles_x


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build(["blend_seq_fwd"])
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")


def phase_k1_parity(params, state):
    """K1 vs its plain version on the card, at the bench shapes."""
    packed, inst, tiles_x = k1_inputs(params, state, demo.demo_camera(W, H))
    args = (packed, inst.tile_start, inst.tile_count, tiles_x)
    got = blend_seq.blend_seq_fwd(*args)
    torch.cuda.synchronize()
    want, visited = blend_seq.blend_tiles_seq_reference(
        *args, return_visited=True)
    err = (got[:, :4] - want[:, :4]).abs().max().item()
    agree = (got[:, 4] == want[:, 4]).float().mean().item()
    print(f"k1 parity: tiles {inst.tile_count.shape[0]}, K {packed.shape[1]}, "
          f"instances {int(inst.tile_count.sum())}, max|d| color/T {err:.3e} "
          f"(atol {ATOL}), n_contrib agree {agree:.6f} "
          f"(>= {CONTRIB_AGREE})")
    check(torch.isfinite(got).all().item(), "K1 output not finite")
    check(err <= ATOL, f"K1 disagrees with its plain version: {err}")
    check(agree >= CONTRIB_AGREE, f"n_contrib agreement {agree}")

    ms = cuda_ms(lambda: blend_seq.blend_seq_fwd(*args), reps=50, warmup=3)
    plain_ms = cuda_ms(lambda: blend_seq.blend_tiles_seq_reference(*args),
                       reps=2)
    pairs = int(visited.sum())
    ops = pairs * K1_OPS_PER_PAIR
    n_inst = int(inst.tile_count.sum())
    num_tiles = inst.tile_count.shape[0]
    nbytes = (blend_pallas.PROWS * n_inst * 4 + 2 * num_tiles * 4
              + num_tiles * 5 * blend_seq.PIX * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    print(f"k1 timing: {ms:.4f} ms/launch (50 launches), plain version "
          f"{plain_ms:.1f} ms; visited pairs {pairs}, {ops:.4g} FP32 ops "
          f"-> {t_ops:.4f} ms; {nbytes} bytes -> {t_bytes:.4f} ms")
    return {"name": "blend_seq_fwd", "route": "cuda",
            "source": "neuralgaussiansplatting_torch/csrc/blend_seq_fwd.cu",
            "replaces": "neuralgaussiansplatting_tpu/ops/blend_seq.py:91",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def phase_small_reference():
    """The path on the card vs the plain scan oracle on the CPU, at 64x64:
    preprocess and binning on the GPU, K1, and assembly, end to end."""
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


def phase_serve(params, state, k1_row):
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
    blend_seq.launches = 0
    outs = [render(cam, loaded, lstate.alive, deg, bg, SETTINGS)
            for cam in cams]
    torch.cuda.synchronize()
    launches = blend_seq.launches
    check(launches == len(VIEWS),
          f"K1 launched {launches} times for {len(VIEWS)} renders")
    k1_row["launches"] = launches
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(renders):
            render(cam, params, state.alive, SH_DEGREE, bg, SETTINGS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print("profiler: no device time recorded")
        return
    print(f"profiler over {renders} renders: wall {wall_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(e.count for e in kernels) // renders} kernels per render")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / renders:8.3f} ms/render "
              f"x{e.count // renders:<4d} {e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's kernels run "
             "only on an NVIDIA GPU")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    params, state, _ = demo.demo_scene(n=N, w=W, h=H, sh_degree=SH_DEGREE)
    k1_row = phase_k1_parity(params, state)
    phase_small_reference()
    loaded, lstate = phase_serve(params, state, k1_row)
    phase_breakdown(loaded, lstate)

    print(json.dumps({"kernels": [k1_row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
