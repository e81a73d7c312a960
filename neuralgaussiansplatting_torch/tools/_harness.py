"""What the quality harnesses share: the device they run on, their default
paths, the kernels' launch counters, peak device memory, and the
evaluation rows of an entry point's summary."""

from __future__ import annotations

import os
import tempfile
import time

import torch

from neuralgaussiansplatting_torch.ops import blend_pallas
from neuralgaussiansplatting_torch.ops import blend_seq
from neuralgaussiansplatting_torch.ops import zbuffer_pallas


def default_path(name: str) -> str:
    """``name`` under the temporary directory (``TMPDIR`` when set)."""
    return os.path.join(tempfile.gettempdir(), name)


def launch_counts() -> dict:
    """The blend and z-buffer kernels' launch counters (K1-K5)."""
    return {"K1": blend_seq.launches, "K2": blend_seq.bwd_launches,
            "K3": zbuffer_pallas.launches, "K4": blend_pallas.launches,
            "K5": blend_pallas.bwd_launches}


def launches_since(before: dict) -> dict:
    """Launches of each kernel since ``before`` (a ``launch_counts()``),
    the kernels that launched none left out."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def reset_peak_memory(device: torch.device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_memory_bytes(device: torch.device) -> int | None:
    """Peak allocated device memory since ``reset_peak_memory``; None on
    the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device)


def milestone_rows(summary: dict) -> list:
    """The held-out rows of an entry point's summary, in iteration order:
    {"iteration", "l1", "psnr"}, as the JAX harnesses parse them from the
    ``Evaluating test:`` lines."""
    return [{"iteration": it, "l1": ev["test"][0], "psnr": ev["test"][1]}
            for it, ev in sorted(summary["evals"].items()) if "test" in ev]


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def run_entry(entry_main, argv: list, device: torch.device):
    """``entry_main(argv)`` (an entry point's ``main``) in this process.
    Returns its summary and what was measured around it: "wall_clock_s"
    (host clock), "setup_s" (the part before its first iteration: scene
    load, init cloud, trainer), "median_iter_ms", "peak_memory_bytes",
    "launches" (per kernel) and "device"."""
    before = launch_counts()
    reset_peak_memory(device)
    t0 = time.perf_counter()
    summary = entry_main(argv)
    wall = time.perf_counter() - t0
    return summary, {
        "wall_clock_s": wall,
        "setup_s": wall - summary["wall_s"],
        "median_iter_ms": summary["median_iter_ms"],
        "peak_memory_bytes": peak_memory_bytes(device),
        "launches": launches_since(before),
        "device": device_name(device),
    }
