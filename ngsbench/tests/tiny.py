"""A small copy of the benchmark's layout: the mixes, their loops, every
metric reader, and cells "tiny.train" / "tiny.render" of a 72 x 46,
400-Gaussian configuration cut from ``garden840`` (neither side a
multiple of the tile), held to the garden cells' limits."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from ngsbench import harness

REAL = harness.ROOT


def config() -> dict:
    cfg = json.loads((REAL / "ngsbench/configs/garden840.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(name="tiny", n_gaussians=400, width=72, height=46)
    cfg["cameras"].update(views=8, holdout_every=4, orbit_views=5)
    cfg["cloud"]["log_scale_shift"] = -1.5
    return cfg


def layout(root: Path) -> Path:
    """Write the tiny layout under ``root``; returns ``root``."""
    bench = json.loads((REAL / "BENCHMARK.json").read_text())
    pkg = root / "ngsbench"
    for d in ("traffic", "loops", "metrics"):
        shutil.copytree(REAL / "ngsbench" / d, pkg / d)
    (pkg / "configs").mkdir(parents=True)
    (pkg / "limits").mkdir()
    (pkg / "configs/tiny.json").write_text(json.dumps(config()))
    for kind in ("train", "render"):
        shutil.copy(REAL / f"ngsbench/limits/garden840.{kind}.json",
                    pkg / f"limits/tiny.{kind}.json")
    bench["configs"] = [{"name": "tiny", "source": "https://arxiv.org/abs/2308.04079",
                         "file": "ngsbench/configs/tiny.json",
                         "reduced": ["n_gaussians", "width", "height"],
                         "why": "a test's size"}]
    bench["workloads"] = [
        {"name": f"tiny.{k}", "config": "tiny", "traffic": k, "chips": 1,
         "why": "a test's size"} for k in ("train", "render")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"tiny.{w.split('.')[1]}"
                              for w in m["workloads"]][:1]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
