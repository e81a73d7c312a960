"""Neural-feature training from a dataset on disk: the port's ``trainn.py``.

    python -m neuralgaussiansplatting_torch.trainn -s <dataset> -m <out> \\
        [--sw 1|2|3] [--start_checkpoint <model>/chkpnt<N>.ckpt] ...

Trains the fork's neural pipeline on a frozen cloud: per-pixel z-buffer
feature maps (kernel K3) decoded by screen-space networks, ``--sw``
choosing the path (1 MLP; 2 UNet + CNN + denoiser; 3 MLP + CNN +
denoiser). The root ``trainn.py``'s flags, defaults and files: ``cfg_args``,
the scene's ``input.ply`` and ``cameras.json``,
``point_cloud/iteration_N/point_cloud.ply``, video frames and archives
under ``video/iter_N/`` every ``--video_interval``, feature statistics under
``feature_analysis/`` every ``--analysis_interval``, and a held-out
evaluation of the active ``--sw`` path at ``--test_iterations`` (the JAX
package's documented deviation from the reference, which evaluates the
classic render there). Runs on the CUDA device, or on the CPU when
``NGS_PLATFORM=cpu``; there is no fallback from one to the other.

Differences from ``trainn.py``:

- ``--start_checkpoint`` reads the port's own ``chkpnt<N>.ckpt`` (a
  ``torch.save`` file of ``python -m neuralgaussiansplatting_torch.train``,
  loaded with ``weights_only=True``). The JAX package's pickle checkpoints
  hold its own classes, so reading one would import that package; carry a
  JAX model across through ``--start_ply`` instead.
- A progress line every 50 iterations in place of tqdm's bar.
- Without matplotlib the feature plots are skipped (said once at the
  start); the statistics and ``history.csv`` are always written.
- The live render-vs-GT window renders only where a window can open (the
  JAX loop renders headless and discards the image), and renders the alive
  Gaussians only.

``main(argv)`` returns a summary of the run (evaluations, host-clock
iteration times, the video and analysis seconds, the last loss) for callers
in the same process.
"""

from __future__ import annotations

import os
import statistics
import sys
import time
import uuid
from argparse import ArgumentParser

import numpy as np
import torch

from neuralgaussiansplatting_torch import config, resolve_device
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.scene import Scene
from neuralgaussiansplatting_torch.train import neural_loop, optim
from neuralgaussiansplatting_torch.utils import feature_analysis
from neuralgaussiansplatting_torch.utils import image as image_utils
from neuralgaussiansplatting_torch.utils import losses
from neuralgaussiansplatting_torch.utils import video as video_utils
from neuralgaussiansplatting_torch.utils.general import safe_state

PROGRESS_EVERY = 50


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Neural training script parameters")
    config.add_group(parser, config.ModelParams)
    config.add_group(parser, config.OptimizationParams)
    config.add_group(parser, config.PipelineParams)
    parser.add_argument("--sw", type=int, default=2, choices=[1, 2, 3])
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--video_interval", type=int, default=100,
                        help="render video frames every N iterations; "
                             "0 disables")
    parser.add_argument("--analysis_interval", type=int, default=100,
                        help="feature-statistics reports every N iterations; "
                             "0 disables")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--show_interval", type=int, default=300,
                        help="live rendered-vs-GT compare window every N "
                             "iterations; headless-safe")
    parser.add_argument("--model_capacity", type=int, default=None)
    parser.add_argument("--mixed_precision", action="store_true",
                        help="bf16 compute in the screen-space decoders")
    parser.add_argument("--start_checkpoint", type=str, default=None,
                        help="the port's classic-training checkpoint "
                             "(chkpntN.ckpt) to take the frozen geometry "
                             "from")
    parser.add_argument("--start_ply", type=str, default=None,
                        help="alternative geometry source: a saved "
                             "point_cloud.ply from a classic run")
    return parser


def restore_checkpoint_geometry(gaussians: gm.GaussianModel, path: str,
                                capacity: int | None):
    """The model of a ``Trainer.save_checkpoint`` file: SH degree, spatial
    learning-rate scale, parameters and state (its optimizer state is not
    used: only features and decoders train here), re-padded to
    ``capacity`` when given (raises if alive Gaussians would be cut)."""
    payload = torch.load(path, map_location=gaussians.device,
                         weights_only=True)
    gaussians.active_sh_degree = payload["active_sh_degree"]
    gaussians.spatial_lr_scale = payload["spatial_lr_scale"]
    gaussians.params = gm.normalize_params(
        gm.GaussianParams(**payload["params"]))
    gaussians.state = gm.GaussianState(**payload["gstate"])
    if capacity is not None and capacity != gaussians.capacity:
        gaussians.params, gaussians.state = gm.repad(
            gaussians.params, gaussians.state, capacity)


def evaluate(trainer: neural_loop.NeuralTrainer, scene, device) -> dict:
    """{"test"/"train": (mean L1, mean PSNR)} of the active neural path
    over the test cameras and the first five training cameras."""
    result = {}
    render_fn = neural_loop.RENDER_FNS[trainer.sw]
    for name, cams in [("test", scene.get_test_cameras()),
                       ("train", scene.get_train_cameras()[:5])]:
        if not cams:
            continue
        scores = []
        with torch.no_grad():
            for cam in cams:
                out = render_fn(cam.params(device), trainer.ts.params,
                                trainer.ts.net_params, trainer.capacity,
                                alive=trainer.ts.alive)
                img = torch.clamp(out["render"], 0.0, 1.0)
                gt = torch.from_numpy(cam.image).to(device)
                scores.append(torch.stack([losses.l1_loss(img, gt),
                                           losses.psnr(img, gt)]))
        l1, psnr = torch.stack(scores).mean(dim=0).tolist()
        result[name] = (l1, psnr)
    return result


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    args.save_iterations.append(args.iterations)
    device = resolve_device(
        "cpu" if os.environ.get("NGS_PLATFORM") == "cpu" else "cuda")
    dataset = config.extract(config.ModelParams, args)
    if not dataset.model_path:
        dataset.model_path = os.path.join("./output/",
                                          str(uuid.uuid4())[:10])
    print("Optimizing " + dataset.model_path)
    stdout = safe_state(args.quiet)
    try:
        return train(args, dataset, device)
    finally:
        sys.stdout = stdout


def train(args, dataset: config.ModelParams, device: torch.device) -> dict:
    """The run of ``main`` once the arguments are parsed."""
    opt_args = config.extract(config.OptimizationParams, args)
    config.save_cfg_args(dataset.model_path, dataset)
    plots = False
    if args.analysis_interval:
        try:
            import matplotlib  # noqa: F401
            plots = True
        except ImportError:
            print("matplotlib not available: feature plots are skipped "
                  "(statistics and history.csv are written)")

    gaussians = gm.GaussianModel(dataset.sh_degree, device=device)
    scene = Scene(dataset.source_path, dataset.model_path, gaussians,
                  images=dataset.images, resolution=dataset.resolution,
                  white_background=dataset.white_background,
                  eval_split=dataset.eval, capacity=args.model_capacity)
    if args.start_checkpoint:
        restore_checkpoint_geometry(gaussians, args.start_checkpoint,
                                    args.model_capacity)
        print(f"Geometry restored from {args.start_checkpoint} "
              f"({gaussians.num_alive} alive, capacity {gaussians.capacity})")
    elif args.start_ply:
        gaussians.load_ply(args.start_ply, capacity=args.model_capacity)
        print(f"Geometry loaded from {args.start_ply} "
              f"({gaussians.num_alive} alive)")

    opt = optim.OptimizationParams(
        iterations=opt_args.iterations, feature_lr=opt_args.feature_lr,
        lambda_dssim=opt_args.lambda_dssim)
    trainer = neural_loop.NeuralTrainer(
        gaussians, sw=args.sw, opt=opt,
        mixed_precision=args.mixed_precision)

    rng = np.random.default_rng(0)
    stack = []
    cam_cache, gt_cache = {}, {}
    test_iterations = set(args.test_iterations)
    summary = {"evals": {}, "iter_ms": [], "video_s": 0.0,
               "video_frames": 0, "analysis_s": 0.0, "plots": plots}
    ema_loss, metrics = 0.0, None
    t_run = t_last = t_window = time.perf_counter()
    for iteration in range(1, opt.iterations + 1):
        if not stack:
            stack = list(rng.permutation(len(scene.get_train_cameras())))
        cam = scene.get_train_cameras()[stack.pop()]
        cp = cam_cache.get(cam.uid)
        if cp is None:
            cp = cam_cache[cam.uid] = cam.params(device)
        gt = gt_cache.get(cam.uid)
        if gt is None:
            gt = gt_cache[cam.uid] = torch.from_numpy(cam.image).to(device)
        metrics = trainer.step(cp, gt)
        if iteration % PROGRESS_EVERY == 0:
            ema_loss = 0.4 * metrics["loss"].item() + 0.6 * ema_loss
            now = time.perf_counter()
            print(f"Neural training progress: {iteration}/{opt.iterations} "
                  f"loss {ema_loss:.7f}, "
                  f"{1e3 * (now - t_window) / PROGRESS_EVERY:.2f} ms/it")
            t_window = now
        extra = False

        if (args.show_interval and iteration % args.show_interval == 0
                and image_utils._gui_available()):
            extra = True
            with torch.no_grad():
                out = neural_loop.RENDER_FNS[args.sw](
                    cp, trainer.ts.params, trainer.ts.net_params,
                    trainer.capacity, alive=trainer.ts.alive)
            image_utils.show_img2(out["render"].cpu().numpy(), cam.image,
                                  title="render vs gt")

        if (args.video_interval and iteration % args.video_interval == 0
                and scene.get_video_cameras()):
            extra = True
            t0 = time.perf_counter()
            trainer.sync_model()
            frames = video_utils.render_video_frames(
                scene, gaussians, trainer.net_params, iteration,
                dataset.model_path, sw=args.sw)
            summary["video_s"] += time.perf_counter() - t0
            summary["video_frames"] += len(frames)
        if args.analysis_interval and iteration % args.analysis_interval == 0:
            extra = True
            t0 = time.perf_counter()
            trainer.sync_model()
            feats = gaussians.params.features[
                gaussians.state.alive].cpu().numpy()
            feature_analysis.analyze_gaussian_features(
                feats, iteration, dataset.model_path)
            if plots:
                feature_analysis.plot_feature_distributions(
                    feats, iteration, dataset.model_path)
                feature_analysis.plot_density(feats, iteration,
                                              dataset.model_path)
                feature_analysis.plot_64d_analysis(feats, iteration,
                                                   dataset.model_path)
            summary["analysis_s"] += time.perf_counter() - t0

        if iteration in test_iterations:
            extra = True
            evals = evaluate(trainer, scene, device)
            summary["evals"][iteration] = evals
            for name, (l1, psnr) in evals.items():
                print(f"\n[ITER {iteration}] Evaluating {name}: "
                      f"L1 {l1:.5f} PSNR {psnr:.2f}")

        if iteration in args.save_iterations:
            extra = True
            print(f"\n[ITER {iteration}] Saving Gaussians")
            trainer.sync_model()
            scene.save(iteration)

        now = time.perf_counter()
        if not extra:
            summary["iter_ms"].append(1e3 * (now - t_last))
        t_last = now
    if metrics is not None:
        summary["last_loss"] = metrics["loss"].item()
    summary["wall_s"] = time.perf_counter() - t_run
    summary["median_iter_ms"] = (statistics.median(summary["iter_ms"])
                                 if summary["iter_ms"] else None)
    print("\nTraining complete.")
    return summary


if __name__ == "__main__":
    main()
