"""Training-quality proof: an 800x800 lego-class run with the full
reference schedule (SH warm-up, densify 500..15k, opacity reset) to an
iteration / test-PSNR / wall-clock table.

Port of ``tools/train_quality_proof.py``. Generates a self-contained
800x800 dataset with the port's ``tools.make_demo_scene`` (100 train and 25
test views of a 40k-Gaussian procedural mixture, a 10k-point init cloud),
trains it through the port's train entry point (``main`` called in this
process, ``--steps_per_call 10``), evaluates the held-out split at the
milestones and writes ``<out>/quality_proof.json``:

    python -m neuralgaussiansplatting_torch.tools.train_quality_proof \\
        --iters 7000 --out <dir> --scene <dir>

The JSON has the JAX tool's keys, and beside them the run's median
iteration (host clock), the drops at each tune point, the final alive
count and capacity, peak device memory and the K1/K2 launches. Runs on
the CUDA device, or on the CPU when ``NGS_PLATFORM=cpu``.
"""

from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser

from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch.tools import _harness
from neuralgaussiansplatting_torch.tools import make_demo_scene
from neuralgaussiansplatting_torch.train import __main__ as train_entry

SCHEDULE = ("reference defaults (SH warmup 1k, densify 500..15000 every "
            "100, opacity reset 3000)")


def build_parser() -> ArgumentParser:
    ap = ArgumentParser()
    ap.add_argument("--scene", default=_harness.default_path("q_scene"))
    ap.add_argument("--out", default=_harness.default_path("q_proof"))
    ap.add_argument("--iters", type=int, default=7000)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--gt_gaussians", type=int, default=40000)
    ap.add_argument("--init_points", type=int, default=10000)
    ap.add_argument("--skip_gen", action="store_true")
    ap.add_argument("--backend", default="seq")
    ap.add_argument("--fast_sort", action="store_true",
                    help="packed [tile|depth] sort key, the bench's "
                         "configuration: run the proof with it so the perf "
                         "number and the quality number describe the same "
                         "code path")
    return ap


def milestones(iters: int) -> list:
    return sorted({1000, 3000, 5000, iters, min(7000, iters)})


def entry_args(args) -> list:
    """The train entry point's arguments for the parsed harness flags."""
    ms = milestones(args.iters)
    return (["-s", args.scene, "-m", args.out, "--eval",
             "--iterations", str(args.iters),
             "--test_iterations", *[str(m) for m in ms],
             "--save_iterations", str(args.iters),
             "--steps_per_call", "10",
             "--backend", args.backend]
            + (["--fast_sort"] if args.fast_sort else [])
            + ["--disable_viewer"])


def generate(args) -> float:
    """Write the dataset unless it is there (or ``--skip_gen``); returns
    the seconds it took."""
    if args.skip_gen or os.path.exists(
            os.path.join(args.scene, "transforms_train.json")):
        return 0.0
    t0 = time.perf_counter()
    make_demo_scene.main([
        "--out", args.scene, "--size", str(args.size),
        "--views", str(args.views),
        "--n_gaussians", str(args.gt_gaussians),
        "--init_points", str(args.init_points),
        "--device", platform_device().type])
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = platform_device()
    gen_s = generate(args)

    summary, measured = _harness.run_entry(train_entry.main,
                                           entry_args(args), device)
    result = {
        "dataset": {
            "generator": "neuralgaussiansplatting_torch/tools/"
                         "make_demo_scene.py",
            "resolution": args.size, "train_views": args.views,
            "test_views": max(args.views // 4, 2),
            "gt_gaussians": args.gt_gaussians,
            "init_points": args.init_points,
        },
        "schedule": SCHEDULE,
        "fast_sort": args.fast_sort,
        "iterations": args.iters,
        "test_psnr": _harness.milestone_rows(summary),
        "scene_gen_s": gen_s,
        "tune_drops": summary["tune"],
        "alive": summary["alive"],
        "capacity": summary["capacity"],
        **measured,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "quality_proof.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
