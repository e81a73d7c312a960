"""Full evaluation harness: the port's ``full_eval.py``.

    python -m neuralgaussiansplatting_torch.full_eval -m360 <dir> \\
        -tat <dir> -db <dir> [--output_path ./eval] [--skip_training] ...

Trains, renders and scores the standard suites (MipNeRF360 outdoor scenes
at ``-i images_4``, indoor at ``images_2``; Tanks&Temples; Deep Blending)
by running the port's entry points (``python -m
neuralgaussiansplatting_torch.train``, ``.render`` and ``.metrics``) with
the flags the root ``full_eval.py`` gives the root CLIs. Each command is an
argument list run by ``run`` (``subprocess.run``), not a shell string.
``main(argv)`` returns the commands and their exit codes.
"""

from __future__ import annotations

import subprocess
import sys
from argparse import ArgumentParser

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump",
                             "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]


def entry(name: str) -> list:
    """The command line of the port's entry point ``name``."""
    return [sys.executable, "-m", f"neuralgaussiansplatting_torch.{name}"]


def run(cmd: list) -> int:
    return subprocess.run(cmd, check=False).returncode


def main(argv=None) -> dict:
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", type=str, default=None)
    parser.add_argument("--tanksandtemples", "-tat", type=str, default=None)
    parser.add_argument("--deepblending", "-db", type=str, default=None)
    args, _ = parser.parse_known_args(argv)

    if not args.skip_training or not args.skip_rendering:
        for name, flag in [("mipnerf360", args.mipnerf360),
                           ("tanksandtemples", args.tanksandtemples),
                           ("deepblending", args.deepblending)]:
            if flag is None:
                print(f"note: --{name} not set; its scenes will be skipped")

    # (scene, source directory, extra training flags), in the suites' order
    suites = []
    if args.mipnerf360:
        suites += [(s, args.mipnerf360 + "/" + s, ["-i", "images_4"])
                   for s in mipnerf360_outdoor_scenes]
        suites += [(s, args.mipnerf360 + "/" + s, ["-i", "images_2"])
                   for s in mipnerf360_indoor_scenes]
    if args.tanksandtemples:
        suites += [(s, args.tanksandtemples + "/" + s, [])
                   for s in tanks_and_temples_scenes]
    if args.deepblending:
        suites += [(s, args.deepblending + "/" + s, [])
                   for s in deep_blending_scenes]

    commands = []
    if not args.skip_training:
        common = ["--quiet", "--eval", "--test_iterations", "-1",
                  "--disable_viewer"]
        for scene, source, extra in suites:
            commands.append(entry("train") + ["-s", source] + extra
                            + ["-m", args.output_path + "/" + scene] + common)
    if not args.skip_rendering:
        common = ["--quiet", "--eval", "--skip_train"]
        for scene, source, _ in suites:
            for iteration in ("7000", "30000"):
                commands.append(entry("render") + [
                    "--iteration", iteration, "-s", source, "-m",
                    args.output_path + "/" + scene] + common)
    if not args.skip_metrics and suites:
        commands.append(entry("metrics") + ["-m"] + [
            f"{args.output_path}/{scene}" for scene, _, _ in suites])
    return {"commands": commands, "returncodes": [run(c) for c in commands]}


if __name__ == "__main__":
    main()
