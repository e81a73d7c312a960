"""Neural-path quality run (the reference's trainn.py workflow at 800x800).

Port of ``tools/train_neural_quality.py``. The neural path trains the
64-d per-Gaussian features and the screen-space decoders on frozen
geometry (``--sw 2``: UNet, CNN kernel predictor and the dynamic 9x9
denoiser). This harness drives the port's ``trainn`` entry point
(``main`` called in this process) on the quality-proof scene, its geometry
from the classic quality run's saved PLY, and writes an iteration /
test-PSNR table to ``<out>/neural_quality.json``:

    python -m neuralgaussiansplatting_torch.tools.train_neural_quality \\
        --iters 3000 --scene <dir> \\
        --start_ply <proof>/point_cloud/iteration_7000/point_cloud.ply

The JSON has the JAX tool's keys, and beside them the median iteration
(host clock), peak device memory and the K3 launches. Runs on the CUDA
device, or on the CPU when ``NGS_PLATFORM=cpu``.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

from neuralgaussiansplatting_torch import trainn as trainn_entry
from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch.tools import _harness


def build_parser() -> ArgumentParser:
    ap = ArgumentParser()
    ap.add_argument("--scene", default=_harness.default_path("q_scene_r4"))
    ap.add_argument("--out",
                    default=_harness.default_path("neural_quality_out"))
    ap.add_argument("--start_ply", default=None)
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--sw", type=int, default=2)
    ap.add_argument("--feature_lr", type=float, default=None,
                    help="A/B knob (reference default 0.0025)")
    ap.add_argument("--mixed_precision", action="store_true",
                    help="bf16 decoders (A/B vs f32)")
    return ap


def milestones(iters: int) -> list:
    return sorted({500, 1000, 2000, 3000, 5000, iters // 2, iters} - {0})


def entry_args(args) -> list:
    """The neural entry point's arguments for the parsed harness flags."""
    cmd = ["-s", args.scene, "-m", args.out, "--eval",
           "--sw", str(args.sw),
           "--iterations", str(args.iters),
           "--test_iterations", *[str(m) for m in milestones(args.iters)],
           "--save_iterations", str(args.iters),
           "--video_interval", "0", "--analysis_interval", "1000",
           "--show_interval", "0"]
    if args.feature_lr is not None:
        cmd += ["--feature_lr", str(args.feature_lr)]
    if args.mixed_precision:
        cmd += ["--mixed_precision"]
    if args.start_ply:
        cmd += ["--start_ply", args.start_ply]
    return cmd


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = platform_device()
    summary, measured = _harness.run_entry(trainn_entry.main,
                                           entry_args(args), device)
    result = {
        "sw": args.sw, "iterations": args.iters,
        "start_ply": args.start_ply,
        "milestones": _harness.milestone_rows(summary),
        "analysis_s": summary["analysis_s"],
        **measured,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "neural_quality.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
