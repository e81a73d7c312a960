"""What the stage timers share: the checksum of a row's outputs and the
loop that chains each selected row and prints it as the JAX tools do.

A row is (name, make_body, carry): ``make_body()`` returns the chain body,
(carry, eps) -> carry. A row whose name is in the tool's
``no_counterpart`` map times a TPU-only variant that the port does not
have: it is printed as ``no counterpart: <reason>`` in place of a time.
"""

from __future__ import annotations

import torch

from neuralgaussiansplatting_torch.tools import _harness
from neuralgaussiansplatting_torch.tools.chain_bench import TIMING, chain


def sums(*arrs) -> torch.Tensor:
    """The float32 sum of every element of ``arrs`` (the JAX tools'
    checksum)."""
    return sum(a.float().sum() for a in arrs)


def row_line(label: str, width: int, ms: float | None,
             reason: str | None = None, ms_width: int = 8) -> str:
    """A row as the JAX tools print it, ``label`` padded to ``width``."""
    if reason is not None:
        return f"  {label:{width}s} no counterpart: {reason}"
    return f"  {label:{width}s} {ms:{ms_width}.2f} ms"


def run_rows(rows, no_counterpart: dict, width: int, selection=(),
             iters: int = 8, reps: int = 2, numbered: bool = True,
             ms_width: int = 8) -> list:
    """Chain each row of ``rows`` whose id is in ``selection`` (every row
    when it is empty) and print it; returns {"id", "name", "ms",
    "no_counterpart"} per row run. ``numbered`` prints the id as the
    JAX tools that number their rows do ("[i] name"); ``ms_width`` is
    the time's field width."""
    out = []
    for i, (name, make_body, carry) in enumerate(rows):
        if selection and str(i) not in selection:
            continue
        reason = no_counterpart.get(name)
        ms = None if reason else chain(make_body, carry, iters=iters,
                                       reps=reps)
        label = f"[{i}] {name}" if numbered else name
        pad = width + 3 + len(str(i)) if numbered else width
        print(row_line(label, pad, ms, reason, ms_width), flush=True)
        out.append({"id": i, "name": name, "ms": ms,
                    "no_counterpart": reason})
    return out


def result(rows: list, before: dict, device: torch.device, **extra) -> dict:
    """A stage timer's return value: its rows, how they were timed, the
    kernels' launches since ``before`` and the device."""
    return {"rows": rows, **extra, "timing": TIMING,
            "launches": _harness.launches_since(before),
            "device": _harness.device_name(device)}
