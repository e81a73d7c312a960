"""Classic 3DGS training from a dataset on disk: the port's ``train.py``.

    python -m neuralgaussiansplatting_torch.train -s <dataset> -m <out> \\
        [--eval] [--iterations N] ...

The root ``train.py``'s flags, defaults and files (``cfg_args``,
``cfg_args.json``, ``input.ply``, ``cameras.json``,
``point_cloud/iteration_N/point_cloud.ply``, ``chkpnt<N>.ckpt``, a
tensorboard log where ``tensorboardX`` is installed). Runs on the CUDA
device, or on the CPU when ``NGS_PLATFORM=cpu``; there is no fallback from
one to the other.

Differences from ``train.py``: a progress line every 50 iterations in place
of tqdm's bar; the viewer (``network_gui``) is not ported, so the run is
headless; ``--debug`` / ``--debug_from`` reach the ``Trainer`` (a non-finite
loss writes ``snapshot_fw.pt`` into the model directory and raises);
``--profile_dir`` writes a ``torch.profiler`` trace of iterations 100-110;
``--detect_anomaly`` turns on autograd's anomaly mode; ``--data_parallel``
and ``--steps_per_call`` above 1 are refused. ``main(argv)`` returns a
summary of the run (evaluations, iteration times, the last loss) for
callers in the same process.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import sys
import time
import uuid
from argparse import ArgumentParser

import numpy as np
import torch

from neuralgaussiansplatting_torch import config, resolve_device
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.scene import Scene
from neuralgaussiansplatting_torch.train import loop, optim
from neuralgaussiansplatting_torch.utils import losses
from neuralgaussiansplatting_torch.utils.general import safe_state

PROGRESS_EVERY = 50


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Training script parameters")
    config.add_group(parser, config.ModelParams)
    config.add_group(parser, config.OptimizationParams)
    config.add_group(parser, config.PipelineParams)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--model_capacity", type=int, default=None,
                        help="Gaussian slot capacity (default: point count)")
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--tune_interval", type=int, default=500,
                        help="iterations between instance-capacity "
                             "re-bucketing checks (and drop-monitor reads). "
                             "Align with --densification_interval on "
                             "fast-growing scenes: demand spikes right "
                             "after densify, and instances drop until the "
                             "next tune point re-buckets the buffers")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="iterations per dispatch; only 1 is ported")
    parser.add_argument("--gt_cache_mb", type=int, default=4096,
                        help="device-side GT image cache budget (MB); "
                             "avoids re-uploading GT every iteration")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="data-parallel devices; only 1 is ported")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of iterations "
                             "100..110 to this directory")
    return parser


def training_report(tb_writer, iteration, metrics, trainer, scene, settings,
                    test_iterations):
    """Tensorboard scalars (buffered on the device, read ten at a time) and,
    at ``test_iterations``, the held-out evaluation: mean L1 and PSNR over
    the test cameras and the first five training cameras, rendered with
    ``settings``. Returns {"test"/"train": (l1, psnr)} at an evaluation,
    else None."""
    if tb_writer and metrics:
        buf = getattr(tb_writer, "_ngs_pending", None)
        if buf is None:
            buf = tb_writer._ngs_pending = []
        buf.append((iteration, metrics["loss"], trainer.ts.gstate.alive.sum()))
        if (len(buf) >= 10 or iteration % 500 == 0
                or iteration in test_iterations):
            values = torch.stack([torch.stack([loss.float(), alive.float()])
                                  for _, loss, alive in buf]).tolist()
            for (it, _, _), (loss, alive) in zip(buf, values):
                tb_writer.add_scalar("train_loss_patches/total_loss", loss, it)
                tb_writer.add_scalar("total_points", int(alive), it)
            buf.clear()
        if iteration % 500 == 0:
            alive = trainer.ts.gstate.alive
            op = gm.get_opacity(trainer.ts.params)[alive].cpu().numpy()
            if len(op):
                tb_writer.add_histogram("scene/opacity_histogram", op,
                                        iteration)

    if iteration not in test_iterations:
        return None
    dev = trainer.ts.params.xyz.device
    result = {}
    for name, cams in [("test", scene.get_test_cameras()),
                       ("train", scene.get_train_cameras()[:5])]:
        if not cams:
            continue
        scores = []
        with torch.no_grad():
            for cam in cams:
                out = render(cam.params(dev), trainer.ts.params,
                             trainer.ts.gstate.alive,
                             trainer.gaussians.active_sh_degree,
                             trainer.bg, settings)
                img = torch.clamp(out["render"], 0.0, 1.0)
                gt = torch.from_numpy(cam.image).to(dev)
                scores.append(torch.stack([losses.l1_loss(img, gt),
                                           losses.psnr(img, gt)]))
        l1, psnr = torch.stack(scores).mean(dim=0).tolist()
        result[name] = (l1, psnr)
        print(f"\n[ITER {iteration}] Evaluating {name}: "
              f"L1 {l1:.5f} PSNR {psnr:.2f}")
        if tb_writer:
            tb_writer.add_scalar(f"{name}/loss_viewpoint - psnr", psnr,
                                 iteration)
    return result


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    args.save_iterations.append(args.iterations)
    if args.data_parallel > 1:
        raise SystemExit("--data_parallel > 1 is not ported yet (ROADMAP "
                         "queue 1: parallel, torch.distributed)")
    if args.steps_per_call > 1:
        raise SystemExit("--steps_per_call > 1 is not ported yet (ROADMAP "
                         "queue 1: a CUDA graph of train_step)")

    device = resolve_device(
        "cpu" if os.environ.get("NGS_PLATFORM") == "cpu" else "cuda")
    dataset = config.extract(config.ModelParams, args)
    if not dataset.model_path:
        dataset.model_path = os.path.join(
            "./output/", os.getenv("OAR_JOB_ID", str(uuid.uuid4())[:10]))
    print("Optimizing " + dataset.model_path)
    stdout = safe_state(args.quiet)
    anomaly = torch.is_anomaly_enabled()
    try:
        torch.autograd.set_detect_anomaly(args.detect_anomaly or anomaly)
        return train(args, dataset, device)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        sys.stdout = stdout


def train(args, dataset: config.ModelParams, device: torch.device) -> dict:
    """The run of ``main`` once the arguments are parsed."""
    opt_args = config.extract(config.OptimizationParams, args)
    pipe = config.extract(config.PipelineParams, args)
    config.save_cfg_args(dataset.model_path, dataset)
    if not args.disable_viewer:
        print("the viewer (network_gui) is not ported yet; running headless")

    tb_writer = None
    try:
        from tensorboardX import SummaryWriter
        tb_writer = SummaryWriter(dataset.model_path)
    except ImportError:
        print("tensorboard not available: not logging progress")

    gaussians = gm.GaussianModel(dataset.sh_degree, device=device)
    scene = Scene(dataset.source_path, dataset.model_path, gaussians,
                  images=dataset.images, resolution=dataset.resolution,
                  white_background=dataset.white_background,
                  eval_split=dataset.eval, capacity=args.model_capacity)
    settings = rast.make_settings(
        pipe.backend, capacity=pipe.capacity, max_per_tile=pipe.max_per_tile,
        tight_culling=pipe.tight_culling, expand=pipe.expand,
        dense_cap=pipe.dense_cap, precise_cull=pipe.precise_cull,
        fast_sort=pipe.fast_sort)
    opt = optim.OptimizationParams(
        **{f.name: getattr(opt_args, f.name)
           for f in dataclasses.fields(optim.OptimizationParams)})
    trainer = loop.Trainer(
        gaussians=gaussians, opt=opt, settings=settings,
        white_background=dataset.white_background,
        cameras_extent=scene.cameras_extent,
        debug=pipe.debug, debug_from=args.debug_from,
        snapshot_dir=dataset.model_path,
        tune_interval=args.tune_interval)

    first_iter = 0
    if args.start_checkpoint:
        first_iter = trainer.restore_checkpoint(args.start_checkpoint)
        print(f"Resumed from {args.start_checkpoint} at iteration "
              f"{first_iter}")

    rng = np.random.default_rng(0)
    stack = []
    cam_cache, gt_cache, gt_cache_bytes = {}, {}, 0
    test_iterations = set(args.test_iterations)
    summary = {"first_iter": first_iter, "evals": {}, "iter_ms": [],
               "tune": []}
    ema_loss, profiler, metrics = 0.0, None, None
    t_run = t_last = t_window = time.perf_counter()
    for iteration in range(first_iter + 1, opt.iterations + 1):
        if args.profile_dir and iteration == 100:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        if profiler is not None and iteration == 110:
            profiler.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(args.profile_dir, "trace.json"))
            profiler = None
            print(f"\nprofiler trace written to {args.profile_dir}")

        if not stack:
            stack = list(rng.permutation(len(scene.get_train_cameras())))
        cam = scene.get_train_cameras()[stack.pop()]
        cp = cam_cache.get(cam.uid)
        if cp is None:
            cp = cam_cache[cam.uid] = cam.params(device)
        gt = gt_cache.get(cam.uid)
        if gt is None:
            gt = torch.from_numpy(cam.image).to(device)
            if gt_cache_bytes < args.gt_cache_mb * (1 << 20):
                gt_cache[cam.uid] = gt
                gt_cache_bytes += gt.numel() * 4

        # evaluated after the gradient step and before density control, as
        # the reference does
        metrics = trainer.grad_step(cp, gt, iteration)
        # trainer.settings, not the startup settings: the autotune
        # re-buckets capacities to demand, and an evaluation with the
        # startup buffers truncates large renders
        evals = training_report(tb_writer, iteration, metrics, trainer,
                                scene, trainer.settings, test_iterations)
        if evals:
            summary["evals"][iteration] = evals
        if iteration in args.save_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            trainer.sync_model()
            scene.save(iteration)
        metrics = trainer.apply_schedule(iteration, metrics)
        if iteration % trainer.tune_interval == 0:
            summary["tune"].append((iteration, int(metrics["dropped"])))
        if iteration in args.checkpoint_iterations:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            trainer.save_checkpoint(
                os.path.join(scene.model_path, f"chkpnt{iteration}.ckpt"),
                iteration)

        now = time.perf_counter()
        if not (evals or "densify" in metrics
                or iteration in args.save_iterations
                or iteration in args.checkpoint_iterations):
            summary["iter_ms"].append(1e3 * (now - t_last))
        t_last = now
        if iteration % PROGRESS_EVERY == 0:
            ema_loss = 0.4 * metrics["loss"].item() + 0.6 * ema_loss
            now = time.perf_counter()
            print(f"Training progress: {iteration}/{opt.iterations} "
                  f"loss {ema_loss:.7f}, "
                  f"{1e3 * (now - t_window) / PROGRESS_EVERY:.2f} ms/it")
            t_window = t_last = now
    if profiler is not None:
        profiler.stop()
    if tb_writer:
        tb_writer.close()
    if metrics is not None:
        summary["last_loss"] = metrics["loss"].item()
    summary["wall_s"] = time.perf_counter() - t_run
    summary["median_iter_ms"] = (statistics.median(summary["iter_ms"])
                                 if summary["iter_ms"] else None)
    print("\nTraining complete.")
    if metrics is not None:
        print(f"last loss {summary['last_loss']:.7f}")
    return summary


if __name__ == "__main__":
    main()
