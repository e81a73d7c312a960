"""GT-recovery oracle for the training-quality gap.

Port of ``tools/exp_quality_oracle.py``. The quality-proof scene's ground
truth images are renders of a known 40k-Gaussian mixture
(``make_demo_scene.gt_gaussians``, a fixed seed), so the model class can
represent the scene exactly. Each mode trains the port's ``Trainer`` from
another start and reads the test PSNR at milestones:

  hold       the trainer set AT the ground-truth parameters, then the full
             schedule (densify, opacity reset, SH warm-up): a falling PSNR
             puts the fault in the schedule or the optimizer.
  hold_pure  the same start with the schedule off (Adam alone): optimizer
             noise apart from density-control churn.
  gtcloud    the ground-truth point cloud (exact positions and colours,
             the standard scale and opacity init): how far training gets
             when only scales, opacities and SH are to be found.
  sweep      short runs from the scene's init cloud over
             densify_grad_threshold {1e-4, 2e-4, 4e-4}.

    python -m neuralgaussiansplatting_torch.tools.exp_quality_oracle \\
        [hold|hold_pure|gtcloud|sweep] [--scene <dir>] [--iters 2000]

Runs on the CUDA device (K1 and K2 each iteration, K1 for each
evaluation render), or on the CPU when ``NGS_PLATFORM=cpu``. Unlike the
JAX tool it writes no model directory (the ``Scene`` is given none).
``main(argv)`` returns what it prints.
"""

from __future__ import annotations

import json
import time
from argparse import ArgumentParser

import numpy as np
import torch

from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops.sh import RGB2SH
from neuralgaussiansplatting_torch.scene import Scene
from neuralgaussiansplatting_torch.scene.dataset_readers import (
    BasicPointCloud)
from neuralgaussiansplatting_torch.tools import _harness
from neuralgaussiansplatting_torch.tools.make_demo_scene import gt_gaussians
from neuralgaussiansplatting_torch.train import loop, optim
from neuralgaussiansplatting_torch.utils import losses
from neuralgaussiansplatting_torch.utils.general import inverse_sigmoid

GT_GAUSSIANS = 40_000      # the quality-proof scene's mixture
GT_CAPACITY = 1 << 17      # slots of the hold and gtcloud models
SETTINGS = dict(capacity=1 << 20, max_per_tile=4096, tight_culling=True)
MODES = ("hold", "hold_pure", "gtcloud", "sweep")
SWEEP_THRESHOLDS = (1e-4, 2e-4, 4e-4)


def build_gt_params(sh_degree: int, capacity: int, device="cuda"):
    """(GaussianParams, GaussianState) on ``device`` set exactly at the
    generator's ground-truth mixture, padded to ``capacity`` slots."""
    means, scales, rot, opac, colors = gt_gaussians(GT_GAUSSIANS)
    n = means.shape[0]
    k = (sh_degree + 1) ** 2

    def pad(a):
        return np.pad(a, [(0, capacity - n)] + [(0, 0)] * (a.ndim - 1))

    rotp = pad(rot)
    rotp[n:, 0] = 1.0
    opacity = inverse_sigmoid(torch.from_numpy(opac[:, None])).numpy()
    params = dict(
        xyz=pad(means),
        normals=np.zeros((capacity, 3), np.float32),
        features_dc=pad(RGB2SH(colors).astype(np.float32)),
        features_rest=np.zeros((capacity, 3 * (k - 1)), np.float32),
        features=np.zeros((capacity, gm.NUM_NEURAL_FEATURES), np.float32),
        scaling=pad(np.log(scales).astype(np.float32)),
        rotation=rotp.astype(np.float32),
        opacity=pad(opacity.astype(np.float32)),
    )
    state = dict(
        alive=np.arange(capacity) < n,
        max_radii2d=np.zeros(capacity, np.float32),
        xyz_gradient_accum=np.zeros(capacity, np.float32),
        denom=np.zeros(capacity, np.float32),
    )
    return gm.params_from_numpy(params, state, device=device)


def evaluate(trainer, cams, settings, n_cams: int = 8) -> float:
    """Mean test PSNR of the trainer's model over the first ``n_cams``
    cameras, the render clipped to [0, 1]."""
    dev = trainer.ts.params.xyz.device
    psnrs = []
    with torch.no_grad():
        for cam in cams[:n_cams]:
            out = render(cam.params(dev), trainer.ts.params,
                         trainer.ts.gstate.alive,
                         trainer.gaussians.active_sh_degree, trainer.bg,
                         settings)
            img = torch.clamp(out["render"], 0.0, 1.0)
            psnrs.append(losses.psnr(img, torch.from_numpy(cam.image)
                                     .to(dev)))
    return float(np.mean(torch.stack(psnrs).tolist()))


def milestones(iters: int) -> list:
    return sorted({0, 200, 500, 1000, 2000, 3000, 5000, iters}
                  & set(range(0, iters + 1)))


def run(mode: str, scene_dir: str, iters: int,
        thr: float | None = None) -> list:
    """Train ``iters`` iterations in ``mode`` on the scene at
    ``scene_dir``; returns the milestone rows {"iteration", "psnr",
    "alive", "loss"} (no loss at iteration 0) and "elapsed_s", the host
    seconds since the first evaluation began (scene load excluded)."""
    dev = platform_device()
    g = gm.GaussianModel(sh_degree=3, device=dev)
    scene = Scene(scene_dir, "", g, eval_split=True)

    settings = rast.make_settings("seq", **SETTINGS)
    opt_kw = {} if thr is None else {"densify_grad_threshold": thr}
    opt = optim.OptimizationParams(**opt_kw)

    if mode in ("hold", "hold_pure"):
        g.params, g.state = build_gt_params(3, GT_CAPACITY, device=dev)
        g.spatial_lr_scale = scene.cameras_extent
    elif mode == "gtcloud":
        means, _, _, _, colors = gt_gaussians(GT_GAUSSIANS)
        pcd = BasicPointCloud(points=means, colors=colors,
                              normals=np.zeros_like(means))
        g.create_from_pcd(pcd, scene.cameras_extent, capacity=GT_CAPACITY)
    # otherwise the scene's own init cloud (points3d.ply), as loaded

    trainer = loop.Trainer(gaussians=g, opt=opt, settings=settings,
                           cameras_extent=scene.cameras_extent)
    if mode == "hold_pure":
        trainer.auto_grow = False

    train_cams = scene.get_train_cameras()
    test_cams = scene.get_test_cameras()
    rng = np.random.default_rng(0)

    marks = set(milestones(iters))
    t0 = time.perf_counter()
    psnr0 = evaluate(trainer, test_cams, trainer.settings)
    alive0 = int(trainer.ts.gstate.alive.sum())
    rows = [{"iteration": 0, "psnr": psnr0, "alive": alive0,
             "elapsed_s": time.perf_counter() - t0}]
    print(f"[{mode}] iter 0: PSNR {psnr0:.2f} alive {alive0}", flush=True)

    stack = []
    cam_cache, gt_cache = {}, {}
    for it in range(1, iters + 1):
        if not stack:
            stack = list(rng.permutation(len(train_cams)))
        cam = train_cams[stack.pop()]
        if cam.uid not in gt_cache:
            cam_cache[cam.uid] = cam.params(dev)
            gt_cache[cam.uid] = torch.from_numpy(cam.image).to(dev)
        m = trainer.grad_step(cam_cache[cam.uid], gt_cache[cam.uid], it)
        if it in marks:
            psnr = evaluate(trainer, test_cams, trainer.settings)
            alive = int(trainer.ts.gstate.alive.sum())
            loss = float(m["loss"])
            rows.append({"iteration": it, "psnr": psnr, "alive": alive,
                         "loss": loss, "elapsed_s": time.perf_counter() - t0})
            print(f"[{mode}] iter {it}: PSNR {psnr:.2f} alive {alive} "
                  f"loss {loss:.5f}", flush=True)
        if mode != "hold_pure":
            trainer.apply_schedule(it, m)
    return rows


def build_parser() -> ArgumentParser:
    ap = ArgumentParser()
    ap.add_argument("mode", nargs="?", default="hold", choices=MODES)
    ap.add_argument("--scene", default=_harness.default_path("q_scene"))
    ap.add_argument("--iters", type=int, default=2000)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.mode == "sweep":
        out = {}
        for thr in SWEEP_THRESHOLDS:
            print(f"=== densify_grad_threshold {thr} ===", flush=True)
            out[str(thr)] = run("cloudinit_sweep", args.scene, args.iters,
                                thr=thr)
    else:
        out = {args.mode: run(args.mode, args.scene, args.iters)}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
