"""Render-rate benchmark on a trained model (not the random splat field
of the bench): loads a saved point_cloud.ply, sizes the instance buffers
from a demand probe, and reports the chained 1080p forward rate and the
fwd+bwd step rate.

Port of ``tools/bench_trained_scene.py``. The reference's ">= 30 fps at
1080p" is about trained real scenes, whose instance demand and early exit
differ from the synthetic worst case; this reports the trained side. One
fixed camera (50 degree fov, at (0, -3.4, 1.2) looking at the origin); the
probe render (seq, capacity 2^22, 8192 per tile, fast sort, tight and
precise cull) sizes ``capacity`` (the next power of two above 1.15 x the
instances, at least 2^16) and ``packed_capacity`` (1.05 x the aligned
demand rounded up to a multiple of 2^17); ``tools.chain_bench.chain``
times 8 chained forwards and 6 chained fwd+bwd steps, best of 2.

    python -m neuralgaussiansplatting_torch.tools.bench_trained_scene \\
        -m <model_dir> [--iteration N]

Prints one JSON line with the JAX tool's keys, and beside them the probe's
drops, the launches per kernel and the device; ``main(argv)`` returns it.
Runs on the CUDA device (K1, and K2 in the fwd+bwd steps), or on the CPU
when ``NGS_PLATFORM=cpu``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from argparse import ArgumentParser

import numpy as np
import torch

from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops.preprocess import CameraParams
from neuralgaussiansplatting_torch.scene.scene import search_for_max_iteration
from neuralgaussiansplatting_torch.tools import _harness
from neuralgaussiansplatting_torch.tools.chain_bench import (
    chain, forward_body, fwd_bwd_body)

PROBE = rast.make_settings("seq", capacity=1 << 22, max_per_tile=8192,
                           fast_sort=True, tight_culling=True,
                           precise_cull=True)
FWD_ITERS, FWDBWD_ITERS, REPS = 8, 6, 2


def bench_camera(w: int, h: int, device) -> CameraParams:
    """The tool's fixed camera at ``w`` x ``h``."""
    fovx = math.radians(50.0)
    fovy = proj.focal2fov(proj.fov2focal(fovx, w), h)
    projm = proj.get_projection_matrix(0.01, 100.0, fovx, fovy)
    pos = np.array([0.0, -3.4, 1.2])
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    R = np.stack([right, true_up, fwd], axis=1)
    view = proj.get_world_to_view(R, -R.T @ pos)
    return CameraParams(
        view=view, full_proj=projm @ view, campos=pos.astype(np.float32),
        tan_fovx=math.tan(fovx / 2), tan_fovy=math.tan(fovy / 2),
        width=w, height=h, device=device)


def sized_settings(num_rendered: int, aligned_demand: int):
    """``PROBE`` with the buffers sized from the probe's demand."""
    cap = 1 << max(int(num_rendered * 1.15).bit_length(), 16)
    kcap = ((int(aligned_demand * 1.05) >> 17) + 1) << 17
    return dataclasses.replace(PROBE, capacity=cap, packed_capacity=kcap)


def build_parser() -> ArgumentParser:
    ap = ArgumentParser()
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = platform_device()
    pc_dir = os.path.join(args.model_path, "point_cloud")
    it = (args.iteration if args.iteration > 0
          else search_for_max_iteration(pc_dir))
    ply = os.path.join(pc_dir, f"iteration_{it}", "point_cloud.ply")
    g = gm.GaussianModel(sh_degree=3, device=dev)
    g.load_ply(ply)
    params, alive = g.params, g.state.alive
    n_alive = int(alive.sum())

    w, h = args.width, args.height
    cam = bench_camera(w, h, dev)
    bg = torch.zeros(3, device=dev)
    before = _harness.launch_counts()
    with torch.no_grad():
        out = render(cam, params, alive, 3, bg, PROBE)
    nr = int(out["num_rendered"])
    ademand = int(out["aligned_demand"])
    settings = sized_settings(nr, ademand)

    t_fwd = chain(lambda: forward_body(cam, alive, 3, settings),
                  (params, torch.zeros((3, h, w), device=dev)),
                  iters=FWD_ITERS, reps=REPS)

    gt = torch.zeros((3, h, w), device=dev)
    t_fb = chain(lambda: fwd_bwd_body(cam, alive, 3, settings, gt), params,
                 iters=FWDBWD_ITERS, reps=REPS)

    result = {
        "model": ply, "n_alive": n_alive, "resolution": f"{w}x{h}",
        "num_rendered": nr, "aligned_demand": ademand,
        "culled": int(out["culled"]),
        "capacity": settings.capacity,
        "packed_capacity": settings.packed_capacity,
        "fwd_ms": t_fwd, "fwd_fps": 1000.0 / t_fwd,
        "fwdbwd_ms": t_fb,
        "fwdbwd_mpix_s": w * h / t_fb / 1e3,
        "dropped": int(out["dropped"]),
        "max_per_tile": int(out["max_per_tile"]),
        "launches": _harness.launches_since(before),
        "device": _harness.device_name(dev),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
