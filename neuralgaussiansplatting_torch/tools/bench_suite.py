"""Extended benchmark suite (one JSON line per metric).

Port of ``tools/bench_suite.py``: the same four workloads, settings, sizing
rule, metric names and keys.

- config 1: 256x256 / 10k Gaussians / SH0, forward+backward (seq: K1, K2);
- config 2: 800x800 / 100k / SH3, forward+backward (seq: K1, K2);
- the 1080p forward-only rate (100k, SH3; seq: K1), its packed capacity
  sized by a demand probe: ``kcap = ((aligned_demand * 1.02 >> 17) + 1)
  << 17`` (``size_from_probe``), printed on a "1080p demand probe" line;
- the neural path, ``render2`` (K3) with its decoders, forward+backward at
  800x800 / 100k / SH1, z-buffer capacity 2^19.

Every scene is ``demo.demo_scene`` (the JAX tool's ``_demo_scene``) at the
JAX tool's ``n``, size and SH degree; the decoders come from the port's
seeded ``init_decoders(0)``.

Timing: ``tools.chain_bench.chain`` chains each step, fed the previous
one's output (8 steps, 6 for the neural one; best of 3 runs less the best
one-step run). The JAX tool chains them inside one jit; here they run
eagerly, so each figure is host clock with the host's dispatch included:
every record carries "timing": "chained eager, host clock", the kernels'
"launches" and the "device" beside the JAX keys.

    python -m neuralgaussiansplatting_torch.tools.bench_suite [--out FILE]

The records are written as a JSON list to ``--out`` (by default
``bench_suite_results.json`` under the temporary directory; never the JAX
package's record at the repository root) and returned by ``main(argv)``.
Runs on the CUDA device, or on the CPU when ``NGS_PLATFORM=cpu``; a probe
that drops instances ends the run with an error.
"""

from __future__ import annotations

import dataclasses
import json
from argparse import ArgumentParser

import torch

from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch.demo import demo_scene
from neuralgaussiansplatting_torch.gaussian_renderer import (
    init_decoders, render)
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.tools import _harness
from neuralgaussiansplatting_torch.tools.chain_bench import (
    TIMING, chain, fwd_bwd_body, neural_fwd_bwd_body)

CONFIG1 = rast.make_settings("seq", capacity=1 << 18, max_per_tile=2048,
                             fast_sort=True, tight_culling=True,
                             precise_cull=True)
CONFIG2 = rast.make_settings("seq", capacity=512 * 1024, max_per_tile=4096,
                             fast_sort=True, tight_culling=True,
                             precise_cull=True, packed_capacity=512 * 1024)
# 32x32 tiles cut the 1080p demand ~2.4x against 16x16; the probe's
# capacity is the power-of-two bucket above that demand
PROBE_1080 = rast.make_settings("seq", capacity=1 << 21, max_per_tile=4096,
                                fast_sort=True, tight_culling=True,
                                precise_cull=True)
NEURAL_CAPACITY = 1 << 19
ITERS, NEURAL_ITERS, REPS = 8, 6, 3
BASELINE_MPIX_S = 1920 * 1080 * 30 / 1e6
BASELINE_FPS = 30.0
# the keys the port's records have beyond the JAX tool's
EXTRA_KEYS = ("timing", "launches", "device")
PROBE_EXTRA_KEYS = ("dropped",)


def size_from_probe(aligned_demand: int) -> int:
    """The 1080p packed capacity: 1.02 x the probe's aligned demand rounded
    up to the next multiple of 2^17."""
    return ((int(aligned_demand * 1.02) >> 17) + 1) << 17


def settings_1080(kcap: int) -> rast.RasterizeSettings:
    """The timed 1080p forward's settings: the probe's, packed capacity
    ``kcap``."""
    return dataclasses.replace(PROBE_1080, packed_capacity=kcap)


def record(metric, value, unit, baseline=None, **extra) -> dict:
    """One record with the JAX tool's rounding, and the port's keys."""
    rec = {"metric": metric, "value": round(value, 3), "unit": unit}
    if baseline:
        rec["vs_baseline"] = round(value / baseline, 4)
    return {**rec, **extra}


def train_step_ms(w, h, n, sh, settings, device, iters=ITERS) -> float:
    """Chained ms per fused render + L1+SSIM + backward step on the demo
    cloud of ``n`` at ``w`` x ``h``, SH degree ``sh``."""
    params, state, cam = demo_scene(n=n, w=w, h=h, sh_degree=sh,
                                    device=device)
    gt = torch.zeros((3, cam.height, cam.width), device=device)
    return chain(lambda: fwd_bwd_body(cam, state.alive, sh, settings, gt),
                 params, iters=iters, reps=REPS)


def probe_1080(device):
    """The demand probe of the 1080p workload: (its cloud, camera, probe
    line and timed settings). Raises when the probe dropped instances."""
    params, state, cam = demo_scene(n=100_000, w=1920, h=1080, sh_degree=3,
                                    device=device)
    with torch.no_grad():
        po = render(cam, params, state.alive, 3,
                    torch.zeros(3, device=device), PROBE_1080)
    ademand = int(po["aligned_demand"])
    kcap = size_from_probe(ademand)
    line = {"metric": "1080p demand probe", "aligned_demand": ademand,
            "culled": int(po["culled"]),
            "num_rendered": int(po["num_rendered"]),
            "packed_capacity": kcap, "dropped": int(po["dropped"])}
    if line["dropped"]:
        raise RuntimeError(f"the 1080p demand probe dropped {line['dropped']}"
                           f" instances at capacity {PROBE_1080.capacity}")
    return (params, state, cam), line, settings_1080(kcap)


def forward_1080_ms(scene, settings) -> float:
    """Chained ms per 1080p forward render; each step's means are shifted
    by the step's eps, and the carried means by 1e-30 x the image mean."""
    params, state, cam = scene
    bg = torch.zeros(3, device=params.xyz.device)

    def make_fwd():
        def step(p, s):
            with torch.no_grad():
                out = render(cam, p._replace(xyz=p.xyz + s), state.alive, 3,
                             bg, settings)
                # full-array mean: the JAX tool's consumer
                return p._replace(xyz=p.xyz + 1e-30 * out["render"].mean())
        return step

    return chain(make_fwd, params, iters=ITERS, reps=REPS)


def neural_step_ms(device) -> float:
    """Chained ms per ``render2`` + L1+SSIM + backward step (features and
    decoders) at 800x800 / 100k / SH1, z-buffer capacity 2^19."""
    params, _, cam = demo_scene(n=100_000, w=800, h=800, sh_degree=1,
                                device=device)
    nets = init_decoders(0, device=device)
    gt = torch.zeros((3, cam.height, cam.width), device=device)
    return chain(lambda: neural_fwd_bwd_body(cam, gt, NEURAL_CAPACITY),
                 (params, nets), iters=NEURAL_ITERS, reps=REPS)


def run(device) -> list:
    """The four workloads on ``device``; prints each record (and the probe
    line) as one JSON line and returns the records."""
    results = []
    name = _harness.device_name(device)

    def emit(before, metric, value, unit, baseline=None):
        rec = record(metric, value, unit, baseline, timing=TIMING,
                     launches=_harness.launches_since(before), device=name)
        results.append(rec)
        print(json.dumps(rec), flush=True)

    before = _harness.launch_counts()
    ms = train_step_ms(256, 256, 10_000, 0, CONFIG1, device)
    emit(before, "fwd+bwd 256x256 10k SH0", 256 * 256 / ms / 1e3, "Mpix/s")

    before = _harness.launch_counts()
    ms = train_step_ms(800, 800, 100_000, 3, CONFIG2, device)
    emit(before, "fwd+bwd 800x800 100k SH3", 800 * 800 / ms / 1e3, "Mpix/s",
         baseline=BASELINE_MPIX_S)

    before = _harness.launch_counts()
    scene, line, settings = probe_1080(device)
    print(json.dumps(line), flush=True)
    ms = forward_1080_ms(scene, settings)
    del scene
    emit(before, "forward 1080p 100k SH3", 1e3 / ms, "fps",
         baseline=BASELINE_FPS)

    before = _harness.launch_counts()
    ms = neural_step_ms(device)
    emit(before, "neural sw2 fwd+bwd 800x800 100k", 800 * 800 / ms / 1e3,
         "Mpix/s")
    return results


def build_parser() -> ArgumentParser:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=_harness.default_path(
        "bench_suite_results.json"))
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    results = run(platform_device())
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
