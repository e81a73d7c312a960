"""One run of one cell: find its parts by name, set up, measure for
``seconds``, trace if asked, free the program, check against the
reference, and return the result line.

A cell of ``BENCHMARK.json`` names a configuration (the file its
``configs`` entry gives), a traffic mix (``traffic/<mix>.json``) and, by
the metrics that list it, per-layer metrics (``metrics/<metric>.py``, or
``metrics/<part before the first dot>.py`` for a metric split by cell
kind). The mix names its loop (``loops/<loop>.py``), which owns what is
particular to a kind of work: its set-up, its operation, its window, the
end-to-end values it reports, the reference it is held to and the
kernels its readers read. Its limits are ``limits/<cell>.json``. A later
cell, mix, loop or metric is a file and an entry; nothing here names one.

A loop module exposes ``KIND`` (the kind of operation, "train" or
"render", which readers split by kind read), ``KERNELS`` (label -> the
name the profiler records, of the kernels its readers need), ``setup(cfg,
mix, seed, device, log, traced)`` (everything before the window: inputs,
buffers, checked and warm-up operations) and ``control(cfg, mix, seed,
device)`` (the control's and the planted faults' numbers, for
``ngsbench.control``). What ``setup`` returns has ``window(seconds)``,
``outcome(window)`` (attempted, failed), ``end_to_end(window)`` ({metric:
value}), ``steps(count, mark)`` (the traced window's operations, returning
their views), ``launches()`` ({label: launches so far}), ``release()``,
``reference(traced window, its views)`` ((the check's numbers, the
counted operations' samples)) and ``facts`` (sizes the readers need).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from ngsbench import check, trace

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "neuralgaussiansplatting_tpu"})


class CellError(RuntimeError):
    """A cell that cannot be run as ``BENCHMARK.json`` states it."""


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise CellError(f"{what}: no file {path}")
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    loop: object          # the mix's loop module
    limits: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list       # (entry, reader module)


def _module(path: Path, tag: str, what: str):
    if not path.is_file():
        raise CellError(f"{what}: no file {path}")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str):
    """The reader module of per-layer metric ``name``."""
    base = root / PKG.name / "metrics"
    stem = name if (base / f"{name}.py").is_file() else name.split(".")[0]
    return _module(base / f"{stem}.py",
                   f"ngsbench_metric_{stem.replace('.', '_')}",
                   f"per-layer metric {name!r}")


def loop_module(root: Path, name: str):
    """The loop module ``loops/<name>.py`` that a mix names."""
    return _module(root / PKG.name / "loops" / f"{name}.py",
                   f"ngsbench_loop_{name}", f"loop {name!r}")


def applies(entry: dict, cell: str, reported=None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry["moves"] in reported


def resolve(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its parts
    loaded; CellError names the part that is missing."""
    bench = _json(root / "BENCHMARK.json", "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"cell {workload!r} is not in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise CellError(f"configuration {w['config']!r} of cell "
                        f"{workload!r} is not in BENCHMARK.json")
    cfg = _json(root / configs[w["config"]]["file"],
                f"configuration {w['config']!r}")
    mix = _json(root / PKG.name / "traffic" / f"{w['traffic']}.json",
                f"traffic mix {w['traffic']!r}")
    loop = loop_module(root, mix["loop"])
    limits = _json(root / PKG.name / "limits" / f"{workload}.json",
                   f"limits of cell {workload!r}")
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [(m, metric_reader(root, m["name"]))
                 for m in bench["per_layer"] if applies(m, workload, names)]
    return Cell(workload, w["chips"], cfg, mix, loop, limits, e2e,
                per_layer)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@dataclasses.dataclass
class TraceData:
    """What a per-layer reader reads: the steady traced window, the
    counted operations whose work the reference counted, and the sizes
    the loop states."""

    kind: str              # the loop's KIND
    ops: int
    window_s: float
    busy_s: float
    kernels: int
    samples: list          # [{kernel label: seconds, "counts": {...}}]
    facts: dict


def card_lines(device) -> list:
    """The card's name, power limit, clocks and draw, from nvidia-smi."""
    if device.type != "cuda":
        return []
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e}"]
    return ["card: " + line for line in out.stdout.strip().splitlines()]


def _profile_ops(loop, kernels: dict, count: int, device, tries: int = 3):
    """A steady traced window of ``count`` operations, taken again while a
    kernel of ``kernels`` (label -> name) kept fewer records than the
    program launched. Returns (window, views, kept all records)."""
    first = None
    for _ in range(tries):
        before = loop.launches()
        with trace.profiled(device) as got:
            with trace.mark("ngsbench.window"):
                views = loop.steps(count, trace.mark)
        after = loop.launches()
        w = got[0]
        short = [k for k, name in kernels.items()
                 if w.recorded(name) < after[k] - before[k]]
        if not short:
            return w, views, True
        first = first or (w, views)
    return first[0], first[1], False


def gc_counts() -> list:
    """The collector's runs so far, by generation."""
    return [g["collections"] for g in gc.get_stats()]


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device,
            t_start: float, log) -> dict:
    """Run ``cell`` once; returns the result line's dict."""
    mod = cell.loop
    lp = mod.setup(cell.config, cell.mix, seed, device, log, traced)
    log("warm")
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    gc_before = gc_counts()
    win = lp.window(seconds)
    gc_window = [b - a for a, b in zip(gc_before, gc_counts())]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    attempted, failed = lp.outcome(win)
    log(f"window: {win.ops} {mod.KIND} operations in {win.seconds} s, "
        f"{failed} of {attempted} failed, collections {gc_window}")

    steady, views = None, []
    if traced:
        steady, views, complete = _profile_ops(
            lp, mod.KERNELS, cell.mix["trace_ops"], device)
        if not complete:
            log("trace: a kernel kept fewer records than launches in every "
                "try; its time is read from its mean record")

    # the program's part is over: free it before the reference runs
    lp.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, samples = lp.reference(steady, views)
    log("reference done")
    ok, checks = check.judge(numbers, cell.limits)

    result = {"correct": ok and attempted > 0, "attempted": attempted,
              "failed": failed}
    metrics = {}
    if not traced:
        values = {"setup_s": setup_s} | lp.end_to_end(win)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise CellError(f"loop {cell.mix['loop']!r} reports no "
                                f"{m['name']!r}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        busy, _ = steady.busy()
        for label, name in mod.KERNELS.items():
            mean = trace.kernel_mean_s(steady.kernels(name))
            for s in samples:
                if label in s and s[label] is None:
                    s[label] = mean
        t = TraceData(kind=mod.KIND, ops=len(views),
                      window_s=steady.end - steady.start, busy_s=busy,
                      kernels=steady.kernel_count(), samples=samples,
                      facts=lp.facts)
        for m, reader in cell.per_layer:
            v = reader.read(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": steady.top_device_ops(),
                               "idle_gaps": steady.idle_gaps()}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1, "memory_peak_bytes": peak}
    if traced:
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = t.window_s
    result["gc_window"] = gc_window
    result["checks"] = checks
    return result
