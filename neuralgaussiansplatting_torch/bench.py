"""Benchmark: fused forward+backward throughput of the tile rasterizer.

Port of the JAX package's root ``bench.py``. Prints ONE JSON line with its
keys, {"metric", "value", "unit", "vs_baseline"}, and beside them
"timing", "launches" (per kernel) and "device"; ``main(argv)`` returns it.

The workload is the JAX tool's: the seeded demo cloud of 100k Gaussians at
SH degree 3 (``demo.demo_scene``, the counterpart of
``__graft_entry__._demo_scene``) at 800x800 on the seq path (32x32 tiles,
chunk 128, capacities 512Ki, 4096 per tile, fast sort, tight and precise
cull): K1 forward and K2 backward once per step. The baseline is a fwd+bwd
step at 30 fps at 1080p, 1920 * 1080 * 30 / 1e6 = 62.2 Mpix/s.

Timing: ``tools.chain_bench.chain`` runs 10 steps, each fed the previous
one's parameters less 1e-30 x its gradients, and takes the best of 3 runs
less the best one-step run. The JAX tool chains its steps inside one jit;
here they run eagerly, so the figure is host clock with the host's
dispatch included ("timing": "chained eager, host clock").

    python -m neuralgaussiansplatting_torch.bench

Runs on the CUDA device, or on the CPU when ``NGS_PLATFORM=cpu``.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser

import torch

from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch.demo import demo_scene
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.tools import _harness
from neuralgaussiansplatting_torch.tools.chain_bench import (
    TIMING, chain, fwd_bwd_body)

W = H = 800
N = 100_000
SH_DEGREE = 3
SETTINGS = rast.RasterizeSettings(block_x=32, block_y=32,
                                  capacity=512 * 1024, max_per_tile=4096,
                                  chunk=128, backend="seq",
                                  fast_sort=True, tight_culling=True,
                                  precise_cull=True,
                                  packed_capacity=512 * 1024)
ITERS, REPS = 10, 3
BASELINE_MPIX_S = 1920 * 1080 * 30 / 1e6
METRIC = "render+backward throughput (800x800, 100k gaussians, SH3)"
# the keys the port's line has beyond the JAX tool's
EXTRA_KEYS = ("timing", "launches", "device")


def run(params, state, cam) -> dict:
    """Chain the bench step on the cloud ``(params, state)`` seen by
    ``cam``; returns the JSON line's dict."""
    dev = params.xyz.device
    gt = torch.zeros((3, cam.height, cam.width), device=dev)
    before = _harness.launch_counts()
    ms = chain(lambda: fwd_bwd_body(cam, state.alive, SH_DEGREE, SETTINGS,
                                    gt), params, iters=ITERS, reps=REPS)
    mpix_s = cam.width * cam.height / ms / 1e3
    return {"metric": METRIC, "value": round(mpix_s, 3), "unit": "Mpix/s",
            "vs_baseline": round(mpix_s / BASELINE_MPIX_S, 4),
            "timing": TIMING, "launches": _harness.launches_since(before),
            "device": _harness.device_name(dev)}


def main(argv=None) -> dict:
    ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    params, state, cam = demo_scene(n=N, w=W, h=H, sh_degree=SH_DEGREE,
                                    device=platform_device())
    result = run(params, state, cam)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
