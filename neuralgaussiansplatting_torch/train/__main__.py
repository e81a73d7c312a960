"""Classic 3DGS training from a dataset on disk: the port's ``train.py``.

    python -m neuralgaussiansplatting_torch.train -s <dataset> -m <out> \\
        [--eval] [--iterations N] [--steps_per_call B] ...
    torchrun --nproc_per_node N -m neuralgaussiansplatting_torch.train \\
        -s <dataset> -m <out> --data_parallel N ...

The root ``train.py``'s flags, defaults and files (``cfg_args``,
``cfg_args.json``, ``input.ply``, ``cameras.json``,
``point_cloud/iteration_N/point_cloud.ply``, ``chkpnt<N>.ckpt``, a
tensorboard log where ``tensorboardX`` is installed), the SIBR remote
viewer on ``--ip`` / ``--port`` (``viewer.network_gui``; "continuing
headless" when the port cannot be bound), ``--steps_per_call`` (blocks of
iterations through ``Trainer.grad_step_block``, flushed at their size, at
the last iteration and at every test, save and checkpoint iteration) and
``--data_parallel N`` (``parallel.train_step.DPTrainer`` over a world of N
processes, one per device, each step consuming N cameras; rank 0 writes
the files and evaluates). Runs on the CUDA device (``cuda:<LOCAL_RANK>``
under ``--data_parallel``, NCCL between the processes), or on the CPU
(gloo) when ``NGS_PLATFORM=cpu``; there is no fallback from one to the
other.

Differences from ``train.py``: a progress line every 50 iterations in
place of tqdm's bar; ``--debug`` / ``--debug_from`` reach the ``Trainer``
(a non-finite loss writes ``snapshot_fw.pt`` into the model directory and
raises; checked per iteration, not inside a block); ``--profile_dir``
writes a ``torch.profiler`` trace of iterations 100-110;
``--detect_anomaly`` turns on autograd's anomaly mode; ``--data_parallel``
counts processes, not visible devices, passes ``--tune_interval`` to the
trainer and serves no viewer. ``main(argv)`` returns a summary of the run
(evaluations, iteration times, tune-point drops, the last loss, the
final alive count and capacity, the viewer frames served) for callers in
the same process.

``--model scaffold`` trains Scaffold-GS instead (``train_scaffold``):
anchors on the voxels of the point cloud at ``--voxel_size``, a fixed
anchor set (the original's growing and pruning are not ported).
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
import torch.distributed as dist

from neuralgaussiansplatting_torch import config, platform_device, resolve_device
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.parallel import distributed
from neuralgaussiansplatting_torch.parallel import mesh as mesh_lib
from neuralgaussiansplatting_torch.parallel.train_step import (DPTrainer,
                                                               stack_cameras)
from neuralgaussiansplatting_torch.scene import Scene
from neuralgaussiansplatting_torch.train import loop, optim
from neuralgaussiansplatting_torch.utils import losses
from neuralgaussiansplatting_torch.utils.general import safe_state
from neuralgaussiansplatting_torch.viewer import network_gui

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
                        help="iterations run as one block "
                             "(Trainer.grad_step_block); pick a divisor of "
                             "densification_interval so schedule events land "
                             "on block boundaries")
    parser.add_argument("--gt_cache_mb", type=int, default=4096,
                        help="device-side GT image cache budget (MB); "
                             "avoids re-uploading GT every iteration")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="data-parallel over N processes, one per "
                             "device (torchrun --nproc_per_node N): each "
                             "optimizer step consumes N cameras, gradients "
                             "are summed over the processes. Mutually "
                             "exclusive with --steps_per_call > 1")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of iterations "
                             "100..110 to this directory")
    parser.add_argument("--model", choices=("3dgs", "scaffold"),
                        default="3dgs",
                        help="scaffold: Scaffold-GS (anchors on the voxels "
                             "of the point cloud, whose MLPs decode 10 "
                             "neural Gaussians a view) through "
                             "ScaffoldTrainer.step on a fixed anchor set: "
                             "anchor growing and pruning are not ported; "
                             "no viewer, evaluation or checkpoints, the "
                             "anchors and nets saved at the last iteration "
                             "(scaffold/iteration_N/scaffold.pt)")
    parser.add_argument("--voxel_size", type=float, default=0.001,
                        help="--model scaffold: the anchors' voxel size")
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


def pipeline_settings(args) -> rast.RasterizeSettings:
    """The rasterizer settings of the parsed pipeline flags (the startup
    settings, before any capacity tuning)."""
    pipe = config.extract(config.PipelineParams, args)
    return rast.make_settings(
        pipe.backend, capacity=pipe.capacity, max_per_tile=pipe.max_per_tile,
        tight_culling=pipe.tight_culling, expand=pipe.expand,
        dense_cap=pipe.dense_cap, precise_cull=pipe.precise_cull,
        fast_sort=pipe.fast_sort)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    args.save_iterations.append(args.iterations)
    if args.data_parallel > 1 and args.steps_per_call > 1:
        raise SystemExit("--data_parallel and --steps_per_call are "
                         "mutually exclusive (a DP step already consumes "
                         "N cameras per dispatch)")
    platform = platform_device().type
    owns_group = False
    if args.data_parallel > 1:
        owns_group = not dist.is_initialized()
        device = distributed.initialize(
            device=distributed.local_device(platform))
        world = mesh_lib.world_size()
        if world != args.data_parallel:
            if owns_group and dist.is_initialized():
                dist.destroy_process_group()
            raise SystemExit(
                f"--data_parallel {args.data_parallel} but the world has "
                f"{world} process(es): start one process per device, e.g. "
                f"torchrun --nproc_per_node {args.data_parallel} -m "
                f"neuralgaussiansplatting_torch.train ...")
    else:
        device = resolve_device(platform)
    dataset = config.extract(config.ModelParams, args)
    if not dataset.model_path:
        dataset.model_path = os.path.join(
            "./output/", os.getenv("OAR_JOB_ID", str(uuid.uuid4())[:10]))
    print("Optimizing " + dataset.model_path)
    stdout = safe_state(args.quiet or mesh_lib.rank() > 0)
    anomaly = torch.is_anomaly_enabled()
    try:
        torch.autograd.set_detect_anomaly(args.detect_anomaly or anomaly)
        return train(args, dataset, device)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        sys.stdout = stdout
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def serve_viewer(gui: network_gui.NetworkGUI, trainer, source_path: str,
                 iteration: int, iterations: int) -> int:
    """The reference's viewer service before an iteration: accept a
    waiting viewer, then answer its requests (a render of its camera with
    the trainer's state, settings and background at its scaling modifier,
    and the source path) until it hands training back; a viewer that
    closes or sends garbage is dropped. Returns the frames sent."""
    if gui.conn is None:
        gui.try_connect()
    frames = 0
    while gui.conn is not None:
        try:
            cam, do_training, _, _, keep_alive, scaling = gui.receive()
            image = None
            if cam is not None:
                with torch.no_grad():
                    out = render(cam, trainer.ts.params,
                                 trainer.ts.gstate.alive,
                                 trainer.gaussians.active_sh_degree,
                                 trainer.bg, trainer.settings,
                                 scaling_modifier=scaling)
                image = network_gui.render_to_bytes(out["render"])
                frames += 1
            gui.send(image, source_path)
            if do_training and (iteration < iterations or not keep_alive):
                break
        except (OSError, ValueError, KeyError):
            gui.drop()
    return frames


def train(args, dataset: config.ModelParams, device: torch.device) -> dict:
    """The run of ``main`` once the arguments are parsed."""
    is_main = mesh_lib.rank() == 0
    opt_args = config.extract(config.OptimizationParams, args)
    pipe = config.extract(config.PipelineParams, args)
    if is_main:
        config.save_cfg_args(dataset.model_path, dataset)
    gui = None
    if not args.disable_viewer and args.data_parallel == 1:
        try:
            gui = network_gui.NetworkGUI(args.ip, args.port, device=device)
        except OSError as e:
            print(f"viewer socket unavailable ({e}); continuing headless")

    tb_writer = None
    try:
        if is_main:
            try:
                from tensorboardX import SummaryWriter
                tb_writer = SummaryWriter(dataset.model_path)
            except ImportError:
                print("tensorboard not available: not logging progress")

        gaussians = gm.GaussianModel(dataset.sh_degree, device=device)
        # only rank 0 writes the scene's files (input.ply, cameras.json)
        scene = Scene(dataset.source_path,
                      dataset.model_path if is_main else "", gaussians,
                      images=dataset.images, resolution=dataset.resolution,
                      white_background=dataset.white_background,
                      eval_split=dataset.eval, capacity=args.model_capacity)
        settings = pipeline_settings(args)
        opt = optim.OptimizationParams(
            **{f.name: getattr(opt_args, f.name)
               for f in dataclasses.fields(optim.OptimizationParams)})
        if args.data_parallel > 1:
            return train_data_parallel(args, scene, gaussians, opt, settings,
                                       dataset, tb_writer, device)
        if args.model == "scaffold":
            return train_scaffold(args, scene, gaussians, settings, dataset,
                                  device)
        trainer = loop.Trainer(
            gaussians=gaussians, opt=opt, settings=settings,
            white_background=dataset.white_background,
            cameras_extent=scene.cameras_extent,
            debug=pipe.debug, debug_from=args.debug_from,
            snapshot_dir=dataset.model_path,
            tune_interval=args.tune_interval)
        return train_loop(args, scene, trainer, device, tb_writer, gui)
    finally:
        if gui is not None:
            gui.close()
        if tb_writer:
            tb_writer.close()


def _finish(summary: dict, trainer, metrics, t_run: float) -> dict:
    if metrics is not None:
        summary["last_loss"] = metrics["loss"].item()
    summary["wall_s"] = time.perf_counter() - t_run
    summary["median_iter_ms"] = (statistics.median(summary["iter_ms"])
                                 if summary["iter_ms"] else None)
    summary["alive"] = int(trainer.ts.gstate.alive.sum())
    summary["capacity"] = trainer.ts.params.xyz.shape[0]
    print("\nTraining complete.")
    if metrics is not None:
        print(f"last loss {summary['last_loss']:.7f}")
    print(alive_line(summary))
    return summary


def alive_line(summary: dict) -> str:
    """The last line of a run: its alive Gaussians and their capacity."""
    return f"alive {summary['alive']} of capacity {summary['capacity']}"


def train_loop(args, scene, trainer: loop.Trainer, device, tb_writer,
               gui) -> dict:
    """The single-process loop: one iteration at a time, or blocks of
    ``--steps_per_call`` iterations."""
    opt = trainer.opt
    first_iter = 0
    if args.start_checkpoint:
        first_iter = trainer.restore_checkpoint(args.start_checkpoint)
        print(f"Resumed from {args.start_checkpoint} at iteration "
              f"{first_iter}")

    rng = np.random.default_rng(0)
    stack = []
    cam_cache, gt_cache, gt_cache_bytes = {}, {}, 0
    test_iterations = set(args.test_iterations)
    spc = max(1, args.steps_per_call)
    pending = []          # (camera, ground truth) awaiting their block
    flush_set = (test_iterations | set(args.save_iterations)
                 | set(args.checkpoint_iterations))
    summary = {"first_iter": first_iter, "evals": {}, "iter_ms": [],
               "tune": [], "viewer": []}
    ema_loss, profiler, metrics = 0.0, None, None
    window_it = first_iter
    t_run = t_last = t_window = time.perf_counter()
    for iteration in range(first_iter + 1, opt.iterations + 1):
        if gui is not None:
            summary["viewer"] += [iteration] * serve_viewer(
                gui, trainer, args.source_path, iteration, opt.iterations)
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
        # the reference does; a block of iterations flushes at its size, at
        # the end, and at every test, save and checkpoint iteration, so the
        # state is current wherever it is read
        done = range(iteration, iteration + 1)
        if spc > 1:
            pending.append((cp, gt))
            if (len(pending) == spc or iteration == opt.iterations
                    or iteration in flush_set):
                done = range(iteration - len(pending) + 1, iteration + 1)
                metrics = trainer.grad_step_block(
                    stack_cameras([c for c, _ in pending]),
                    torch.stack([g for _, g in pending]), done[0])
                pending = []
            else:
                done = range(0)
        else:
            metrics = trainer.grad_step(cp, gt, iteration)
        # trainer.settings, not the startup settings: the autotune
        # re-buckets capacities to demand, and an evaluation with the
        # startup buffers truncates large renders
        evals = training_report(tb_writer, iteration,
                                metrics if done else {}, trainer, scene,
                                trainer.settings, test_iterations)
        if evals:
            summary["evals"][iteration] = evals
        if iteration in args.save_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            trainer.sync_model()
            scene.save(iteration)
        if not done:
            continue
        if spc > 1:
            metrics = trainer.apply_schedule_block(done[0], done[-1], metrics)
        else:
            metrics = trainer.apply_schedule(iteration, metrics)
        if any(i % trainer.tune_interval == 0 for i in done):
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
            summary["iter_ms"].append(1e3 * (now - t_last) / len(done))
        t_last = now
        if iteration % PROGRESS_EVERY < len(done):
            ema_loss = 0.4 * metrics["loss"].item() + 0.6 * ema_loss
            now = time.perf_counter()
            print(f"Training progress: {iteration}/{opt.iterations} "
                  f"loss {ema_loss:.7f}, "
                  f"{1e3 * (now - t_window) / (iteration - window_it):.2f} "
                  f"ms/it")
            t_window = t_last = now
            window_it = iteration
    if profiler is not None:
        profiler.stop()
    return _finish(summary, trainer, metrics, t_run)


def train_scaffold(args, scene, gaussians, settings, dataset,
                   device) -> dict:
    """``--model scaffold``: anchors on the voxels of the scene's point
    cloud (``scaffold.init_anchors``), nets from seed 0, rows for the most
    anchors a training view shows, then ``ScaffoldTrainer.step`` for
    every iteration, one training camera a
    step in ``default_rng(0)`` permutations (its index the appearance
    embedding's row). Returns the summary of ``_finish``'s keys that apply
    (the last loss, iteration times, the anchors)."""
    from neuralgaussiansplatting_torch.models import scaffold
    from neuralgaussiansplatting_torch.train import scaffold_loop
    if args.data_parallel > 1 or args.steps_per_call > 1:
        raise SystemExit("--model scaffold runs one step a call on one "
                         "process")
    alive = gaussians.state.alive
    points = gaussians.params.xyz[alive].detach().cpu().numpy()
    params = scaffold.init_anchors(points, args.voxel_size, device=device)
    cams = scene.get_train_cameras()
    with torch.no_grad():
        visible = max(int(scaffold.visible_anchors(
            c.params(device), params, settings.block_x,
            settings.block_y).sum()) for c in cams)
    trainer = scaffold_loop.ScaffoldTrainer(
        params, scaffold.init_nets(len(cams), 0, device=device),
        anchor_capacity=scaffold_loop.anchor_capacity_for(visible),
        settings=settings, opt=scaffold_loop.ScaffoldOptimizationParams(
            lambda_dssim=args.lambda_dssim),
        white_background=dataset.white_background,
        cameras_extent=scene.cameras_extent,
        tune_interval=args.tune_interval)
    print(f"Scaffold-GS: {params.anchor.shape[0]} anchors from "
          f"{points.shape[0]} points at voxel size {args.voxel_size}")
    rng = np.random.default_rng(0)
    stack, cam_cache, gt_cache = [], {}, {}
    summary = {"first_iter": 0, "evals": {}, "iter_ms": [], "tune": [],
               "viewer": []}
    metrics = None
    iterations = args.iterations
    t_run = t_last = time.perf_counter()
    for iteration in range(1, iterations + 1):
        if not stack:
            stack = list(rng.permutation(len(cams)))
        view = int(stack.pop())
        cam = cams[view]
        if view not in cam_cache:
            cam_cache[view] = cam.params(device)
            gt_cache[view] = torch.from_numpy(cam.image).to(device)
        metrics = trainer.step(cam_cache[view], gt_cache[view], view)
        now = time.perf_counter()
        summary["iter_ms"].append(1e3 * (now - t_last))
        t_last = now
        if iteration % trainer.tune_interval == 0:
            summary["tune"].append((iteration, int(metrics["dropped"])))
        if iteration % PROGRESS_EVERY == 0 or iteration == iterations:
            print(f"Training progress: {iteration}/{iterations} loss "
                  f"{metrics['loss'].item():.7f}, visible anchors "
                  f"{int(metrics['visible_anchors'])}, neural Gaussians "
                  f"{int(metrics['neural_gaussians'])}")
    out = os.path.join(dataset.model_path, "scaffold",
                       f"iteration_{iterations}")
    os.makedirs(out, exist_ok=True)
    torch.save({"params": {k: v.detach().cpu() for k, v in
                           trainer.ts.params._asdict().items()},
                "nets": {k: v.detach().cpu()
                         for k, v in trainer.ts.nets.items()}},
               os.path.join(out, "scaffold.pt"))
    if metrics is not None:
        summary["last_loss"] = metrics["loss"].item()
    summary["wall_s"] = time.perf_counter() - t_run
    summary["median_iter_ms"] = (statistics.median(summary["iter_ms"])
                                 if summary["iter_ms"] else None)
    summary["anchors"] = params.anchor.shape[0]
    print("\nTraining complete.")
    if metrics is not None:
        print(f"last loss {summary['last_loss']:.7f}")
    return summary


def train_data_parallel(args, scene, gaussians, opt, settings, dataset,
                        tb_writer, device) -> dict:
    """``--data_parallel N``: ``DPTrainer`` over the world's N processes,
    N cameras per optimizer step, in the same ``default_rng(0)`` order on
    every rank. The camera counter advances by N, so the schedule keeps the
    cadence of N sequential reference iterations; evaluations, saves and
    checkpoints fire when the counter crosses them, on rank 0."""
    n = args.data_parallel
    is_main = mesh_lib.rank() == 0
    mesh = mesh_lib.make_mesh(n, 1, device=device)
    trainer = DPTrainer(
        gaussians=gaussians, mesh=mesh, opt=opt, settings=settings,
        batch_size=n, white_background=dataset.white_background,
        cameras_extent=scene.cameras_extent, tune_interval=args.tune_interval)
    first_iter = 0
    if args.start_checkpoint:
        first_iter = trainer.restore_checkpoint(args.start_checkpoint)
        print(f"Resumed from {args.start_checkpoint} at iteration "
              f"{first_iter}")

    rng = np.random.default_rng(0)
    stack, cam_cache, gt_cache = [], {}, {}
    part = mesh_lib.batch_sharded(mesh, n)
    tests = set(args.test_iterations)
    saves = set(args.save_iterations)
    checkpoints = set(args.checkpoint_iterations)
    summary = {"first_iter": first_iter, "evals": {}, "iter_ms": [],
               "tune": [], "viewer": []}
    metrics = None
    t_run = t_last = time.perf_counter()
    while trainer._camera_iter < opt.iterations:
        while len(stack) < n:
            stack.extend(rng.permutation(len(scene.get_train_cameras())))
        picks = [scene.get_train_cameras()[int(stack.pop())]
                 for _ in range(n)]
        for c in picks:
            if c.uid not in cam_cache:
                cam_cache[c.uid] = c.params(device)
        for c in picks[part]:
            if c.uid not in gt_cache:
                gt_cache[c.uid] = torch.from_numpy(c.image).to(device)
        metrics = trainer.step([cam_cache[c.uid] for c in picks],
                               [gt_cache.get(c.uid) for c in picks])
        it = trainer._camera_iter
        crossed = set(range(it - n + 1, it + 1))
        if crossed & tests and is_main:
            evals = training_report(tb_writer, it, metrics, trainer, scene,
                                    trainer.settings, {it})
            summary["evals"][it] = evals
        if crossed & saves and is_main:
            print(f"\n[ITER {it}] Saving Gaussians")
            trainer.sync_model()
            scene.save(it)
        if crossed & checkpoints:
            print(f"\n[ITER {it}] Saving Checkpoint")
            trainer.save_checkpoint(
                os.path.join(scene.model_path, f"chkpnt{it}.ckpt"), it)
        if any(i % trainer.tune_interval == 0 for i in crossed):
            summary["tune"].append((it, int(metrics["dropped"])))
        now = time.perf_counter()
        if not (crossed & (tests | saves | checkpoints)
                or "densify" in metrics):
            summary["iter_ms"].append(1e3 * (now - t_last) / n)
        t_last = now
        if it % PROGRESS_EVERY < n:
            print(f"Training progress (DP x{n}): {it}/{opt.iterations} "
                  f"loss {metrics['loss'].item():.7f}")
    trainer.sync_model()
    return _finish(summary, trainer, metrics, t_run)


if __name__ == "__main__":
    main()
