"""Garden-regime benchmark: a multi-million-Gaussian 1080p render and train
step.

Port of ``tools/bench_garden.py``: the same cloud, modes, sizing rule,
monitors and JSON keys. The cloud is the demo cloud of ``n`` Gaussians
(``demo.demo_scene``, seed 3, SH degree 3) with its log-scales lowered by
2.2 (~9x smaller splats, a few tiles each), at 1920x1080. The modes
(``probe_settings``):

- default, "dense": seq (32x32 tiles, K1/K2) with the dense capped
  expansion (every Gaussian owns ``dense_cap`` slots, 6 by default; no
  run-length expansion; the sort domain is n * dense_cap) and precise cull
  off; probe capacity 2^20, 8192 per tile;
- ``--seqscatter``: seq with the run-length expansion over a probe
  capacity of 2^24, 8192 per tile, precise cull off;
- ``--scatter``: ``backend="pallas"`` at the settings' default 32x32 tiles
  (K4/K5), the run-length expansion, probe capacity 2^24, 4096 per tile,
  precise cull on.

One probe render sizes the buffers (``size_from_probe``): capacity
``1 << bit_length(num_rendered * 1.15)`` and packed capacity 1.05 x the
aligned demand rounded up to a multiple of 2^17; the dense mode keeps its
capacity and takes only the packed one (``sized_settings``). One render
with the sized settings gives the monitors. Then ``tools.chain_bench
.chain`` times 6 chained forwards and, unless ``--fwd-only``, 4 chained
fwd+bwd steps, best of 2. The forward's dependency runs through ``xyz``,
so every stage is inside each step. The JAX tool chains inside one jit;
here the steps run eagerly, so each figure is host clock with the host's
dispatch included ("timing": "chained eager, host clock").

    python -m neuralgaussiansplatting_torch.tools.bench_garden \\
        [n_gaussians] [dense_cap] [--fwd-only] [--scatter] [--seqscatter]

Prints one JSON line with the JAX tool's keys and, beside them, "timing",
"launches" (per kernel), "peak_memory_bytes" and "device"; ``main(argv)``
returns it. ``run`` takes a cloud that is already built. Runs on the CUDA
device, or on the CPU when ``NGS_PLATFORM=cpu``.
"""

from __future__ import annotations

import dataclasses
import json
from argparse import ArgumentParser

import torch

from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch.demo import demo_scene
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.tools import _harness
from neuralgaussiansplatting_torch.tools.chain_bench import (
    TIMING, chain, forward_body, fwd_bwd_body)

N, DENSE_CAP = 5_000_000, 6
W, H = 1920, 1080
SEED = 3
MODES = ("dense", "seqscatter", "scatter")
FWD_ITERS, FWDBWD_ITERS, REPS = 6, 4, 2
MONITORS = ("num_rendered", "aligned_demand", "culled", "dropped",
            "max_per_tile")
# the keys the port's line has beyond the JAX tool's
EXTRA_KEYS = ("timing", "launches", "peak_memory_bytes", "device")


def garden_cloud(n: int = N, device="cuda"):
    """(params, state, cam): the demo cloud of ``n`` at 1920x1080, seed 3,
    SH degree 3, its log-scales lowered by 2.2."""
    params, state, cam = demo_scene(n=n, w=W, h=H, sh_degree=3, seed=SEED,
                                    device=device)
    # log-space: ~9x smaller splats
    return params._replace(scaling=params.scaling - 2.2), state, cam


def probe_settings(mode: str, dense_cap: int = DENSE_CAP):
    """The probe render's settings of ``mode`` (one of ``MODES``)."""
    if mode == "seqscatter":
        # seq kernels with the run-length expansion: the sort domain is the
        # true instance capacity, not the dense layout's n * dense_cap
        return rast.make_settings(
            "seq", capacity=1 << 24, max_per_tile=8192, fast_sort=True,
            tight_culling=True, precise_cull=False, expand="scatter")
    if mode == "scatter":
        return rast.RasterizeSettings(
            capacity=1 << 24, max_per_tile=4096, chunk=128, backend="pallas",
            fast_sort=True, tight_culling=True, precise_cull=True)
    if mode == "dense":
        # precise cull off: at garden statistics (tiny splats, ~1.2 tiles
        # each) it culls ~1.4 % of the instances, for bookkeeping over the
        # whole n * dense_cap domain
        return rast.make_settings(
            "seq", capacity=1 << 20, max_per_tile=8192, fast_sort=True,
            tight_culling=True, precise_cull=False, expand="dense",
            dense_cap=dense_cap)
    raise ValueError(f"unknown mode {mode!r}; one of {MODES}")


def size_from_probe(num_rendered: int, aligned_demand: int):
    """(capacity, packed capacity) from a probe's demand: the power of two
    above 1.15 x the instances, and 1.05 x the aligned demand rounded up to
    the next multiple of 2^17."""
    cap = 1 << max(int(num_rendered * 1.15).bit_length(), 1)
    kcap = ((int(aligned_demand * 1.05) // (1 << 17)) + 1) * (1 << 17)
    return cap, kcap


def sized_settings(mode: str, probe, cap: int, kcap: int):
    """The timed settings of ``mode``: the probe's with the sized buffers
    (the dense mode keeps its capacity, the domain being n * dense_cap)."""
    if mode == "dense":
        return dataclasses.replace(probe, packed_capacity=kcap)
    return dataclasses.replace(probe, capacity=cap, packed_capacity=kcap)


def run(params, state, cam, mode: str = "dense", dense_cap: int = DENSE_CAP,
        fwd_only: bool = False) -> dict:
    """Probe, size, and chain the forward (and the fwd+bwd step) of the
    garden cloud ``(params, state)`` seen by ``cam`` in ``mode``; returns
    the JSON line's dict."""
    dev = params.xyz.device
    alive = state.alive
    w, h = cam.width, cam.height
    bg = torch.zeros(3, device=dev)
    before = _harness.launch_counts()
    _harness.reset_peak_memory(dev)
    probe = probe_settings(mode, dense_cap)
    with torch.no_grad():
        out = render(cam, params, alive, 3, bg, probe)
    cap, kcap = size_from_probe(int(out["num_rendered"]),
                                int(out["aligned_demand"]))
    settings = sized_settings(mode, probe, cap, kcap)
    with torch.no_grad():
        out = render(cam, params, alive, 3, bg, settings)
    mon = {k: int(out[k]) for k in MONITORS}
    del out

    t_fwd = chain(lambda: forward_body(cam, alive, 3, settings),
                  (params, torch.zeros((3, h, w), device=dev)),
                  iters=FWD_ITERS, reps=REPS)
    result = {
        "n_gaussians": params.xyz.shape[0], "resolution": f"{w}x{h}",
        "monitors": mon, "capacity": cap, "packed_capacity": kcap,
        "fwd_ms": round(t_fwd, 2), "fwd_fps": round(1000.0 / t_fwd, 2),
    }
    if not fwd_only:
        gt = torch.zeros((3, h, w), device=dev)
        t_fb = chain(lambda: fwd_bwd_body(cam, alive, 3, settings, gt),
                     params, iters=FWDBWD_ITERS, reps=REPS)
        result["fwdbwd_ms"] = round(t_fb, 2)
        result["fwdbwd_mpix_s"] = round(w * h / t_fb / 1e3, 2)
    result.update(timing=TIMING, launches=_harness.launches_since(before),
                  peak_memory_bytes=_harness.peak_memory_bytes(dev),
                  device=_harness.device_name(dev))
    return result


def main(argv=None) -> dict:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_gaussians", nargs="?", type=int, default=N)
    ap.add_argument("dense_cap", nargs="?", type=int, default=DENSE_CAP)
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--scatter", action="store_true")
    ap.add_argument("--seqscatter", action="store_true")
    args = ap.parse_args(argv)
    mode = ("seqscatter" if args.seqscatter
            else "scatter" if args.scatter else "dense")
    params, state, cam = garden_cloud(args.n_gaussians, platform_device())
    result = run(params, state, cam, mode, args.dense_cap, args.fwd_only)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
