"""The program's stages in a torch.profiler window: each device record
charged to the stage whose host call launched it, and a tool that prints
a cell's stages from the card.

The program opens host spans named "ngs.<stage>" while a profiler records
(``neuralgaussiansplatting_torch/utils/timing.span``): "ngs.step" around
``Trainer.step``, "ngs.render" around the classic render and, inside it,
"ngs.preprocess", "ngs.binning" and "ngs.blend"; in the training step
"ngs.loss", "ngs.backward" and "ngs.optimizer". A device record (kernel,
copy or fill) belongs to the innermost span that encloses the host call
that launched it: the CUDA runtime call with the record's correlation id,
followed up its ``cpu_parent`` chain. The record's own time on the device
decides nothing, as the device runs up to a queue's depth behind the
host. Work under "ngs.backward" runs in autograd nodes (on the engine's
own thread on a CUDA device): a record launched inside a node is charged
to "<stage>.bwd", the stage of the forward op that carries the node's
``sequence_nr``, so K2 lands in "blend.bwd" and a gradient sum lands with
the node that accumulates it. A launch that no span or node encloses on
its thread takes the innermost span open on the host at its time; a
record whose launch the trace lacks is charged to no stage (None).

    python -m ngsbench.stages --workload <cell> --seed <n>

sets the cell up as ``ngsbench.run`` does, then runs 3 turns of the mix's
``trace_ops`` operations without and with the profiler, and prints a
JSON line: per turn the untraced and traced ms per
operation and, for the traced window, each stage's device ms, kernels and
host ms per operation, the share of device time charged to no stage, and
the idle gaps labelled "<benchmark range at the gap's start>/<span of the
launch that ends it>". A traced window is taken again where a kernel
that the cell's loop names (``KERNELS``: K1, and K2 in training) kept
fewer records than the launch counters saw (``records``: records and
launches of each); a record that the profiler dropped is in no stage,
so the share charged to none cannot show it. Needs a CUDA card
(exit code 2 without one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

from ngsbench import trace

SPAN_PREFIX = "ngs."
NODE_PREFIX = "autograd::engine::evaluate_function: "


def _cpu(e) -> bool:
    from torch.autograd import DeviceType
    return e.device_type == DeviceType.CPU and not getattr(e, "is_async",
                                                           False)


def _is_launch(e) -> bool:
    """A call of the CUDA API ("cudaLaunchKernel", "cuLaunchKernel",
    "cudaMemcpyAsync", ...): the host's side of a launch, copy or fill."""
    return e.name.startswith("cu")


def _seconds(e) -> tuple[float, float]:
    return e.time_range.start / 1e6, e.time_range.end / 1e6


def span_at(spans: list, t: float) -> str | None:
    """The innermost of ``spans`` (name, start, end) open at ``t``."""
    best, width = None, float("inf")
    for name, s, e in spans:
        if s <= t < e and e - s < width:
            best, width = name, e - s
    return best


class Charger:
    """Stages of the host events of one profiler window."""

    def __init__(self, events):
        cpu = [e for e in events if _cpu(e)]
        self.spans = sorted((e.name,) + _seconds(e) for e in cpu
                            if e.name.startswith(SPAN_PREFIX))
        self.forward = {}       # (thread, sequence_nr) -> the forward op
        for e in cpu:
            if e.sequence_nr >= 0 and self._node(e) is None:
                key = (e.thread, e.sequence_nr)
                # ops that made no node peek the next one's number: the
                # node's own op is the last to start with it
                old = self.forward.get(key)
                if old is None or old.time_range.start <= e.time_range.start:
                    self.forward[key] = e

    @staticmethod
    def _node(e):
        while e is not None:
            if e.name.startswith(NODE_PREFIX):
                return e
            e = e.cpu_parent
        return None

    def stage(self, e) -> str | None:
        """The stage of host event ``e`` (a launch, or any op)."""
        p = e
        while p is not None:
            if p.name.startswith(NODE_PREFIX):
                fwd = self.forward.get((p.fwd_thread, p.sequence_nr))
                owner = self.stage(fwd) if fwd is not None else None
                if owner is not None:
                    return owner + ".bwd"
                break
            if p.name.startswith(SPAN_PREFIX):
                return p.name[len(SPAN_PREFIX):]
            p = p.cpu_parent
        span = span_at(self.spans, _seconds(e)[0])
        return span[len(SPAN_PREFIX):] if span else None


@dataclasses.dataclass
class StagedWindow(trace.Window):
    """A ``trace.Window`` with the program's spans (name, start, end) and,
    for each device record, (its stage or None, its launch's host time or
    None)."""

    spans: list = dataclasses.field(default_factory=list)
    charge: list = dataclasses.field(default_factory=list)

    def _records(self):
        """(name, start, end, stage, launch time) of the device records,
        clipped to the window."""
        for (n, s, e), (stage, t) in zip(self.device, self.charge):
            if e > self.start and s < self.end:
                yield n, max(s, self.start), min(e, self.end), stage, t

    def stage_seconds(self) -> dict:
        """{stage: (device seconds, kernels)} of the records charged to
        each stage, None for those charged to none; kernels leave out
        copies and fills, as ``kernel_count`` does."""
        out = {}
        for n, s, e, stage, _ in self._records():
            sec, k = out.get(stage, (0.0, 0))
            out[stage] = (sec + e - s,
                          k + (not n.startswith(("Memcpy", "Memset"))))
        return out

    def host_seconds(self, span: str) -> float:
        """The host's wall time inside the spans named ``span``, within
        the window."""
        return sum(max(0.0, min(e, self.end) - max(s, self.start))
                   for n, s, e in self.spans if n == span)

    def idle_gaps(self, k: int = 10) -> list:
        """[["<benchmark range>/<span>", seconds]] of the ``k`` longest
        idle gaps: the benchmark range the host was in when the gap opened,
        and the span of the launch of the record that ends it ("-" where
        none does, or its launch is in no span)."""
        launch = {}
        for _, s, _, _, t in self._records():
            if t is not None and s not in launch:
                launch[s] = t
        gaps = sorted(self.busy()[1], key=lambda g: g[0] - g[1])[:k]
        out = []
        for s, e in gaps:
            t = launch.get(e)
            span = span_at(self.spans, t) if t is not None else None
            out.append([f"{self.host_range_at(s)}/{span or '-'}", e - s])
        return out


def window_of(events) -> StagedWindow:
    """The window of a profiler's ``events()``: what ``trace.profiled``
    reads, with the program's spans and each device record's charge."""
    from torch.autograd import DeviceType
    charger = Charger(events)
    launches = {e.id: e for e in events if _cpu(e) and _is_launch(e)}
    dev, charge, ranges, span = [], [], [], None
    for e in events:
        s, t = _seconds(e)
        if trace._device_event(e) and not e.name.startswith(SPAN_PREFIX):
            dev.append((e.name, s, t))
            launch = launches.get(e.id)
            charge.append((None, None) if launch is None else
                          (charger.stage(launch), _seconds(launch)[0]))
        elif (e.name.startswith(trace.RANGE_PREFIX)
              and e.device_type == DeviceType.CPU):
            if e.name == trace.RANGE_PREFIX + "window":
                span = (s, t)
            ranges.append((e.name, s, t))
    if span is None:
        raise RuntimeError("the profiled window has no ngsbench.window span")
    return StagedWindow(dev, ranges, span[0], span[1], spans=charger.spans,
                        charge=charge)


@contextlib.contextmanager
def profiled(device):
    """``trace.profiled``, yielding a list that holds the block's
    ``StagedWindow`` once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = []
    with profile(activities=acts) as prof:
        yield out
    out.append(window_of(prof.events()))


def summary(w: StagedWindow, ops: int) -> dict:
    """The traced window's stages per operation: {"stages": {stage:
    {"device_ms", "kernels", "host_ms"}}, "unattributed_pct", "kernels",
    "idle_pct", "idle_gaps"}. A span's "host_ms" is the host's wall time
    inside it: under a full launch queue that is the device's pace, not
    the host's own cost."""
    per = 1e3 / ops
    secs = w.stage_seconds()
    total = sum(sec for sec, _ in secs.values())
    stages = {}
    for stage, (sec, k) in sorted(secs.items(),
                                  key=lambda kv: -kv[1][0]):
        if stage is None:
            continue
        stages[stage] = {"device_ms": sec * per, "kernels": k / ops}
    for name in sorted({n for n, _, _ in w.spans}):
        st = stages.setdefault(name[len(SPAN_PREFIX):],
                               {"device_ms": 0.0, "kernels": 0.0})
        st["host_ms"] = w.host_seconds(name) * per
    busy, _ = w.busy()
    return {
        "stages": stages,
        "unattributed_pct": (100.0 * secs.get(None, (0.0, 0))[0] / total
                             if total else None),
        "kernels": w.kernel_count() / ops,
        "idle_pct": 100.0 * (1.0 - busy / (w.end - w.start)),
        "idle_gaps": w.idle_gaps(),
    }


def stage_line(s: dict) -> str:
    """One log line of a traced window's stages."""
    parts = [f"{st} {v['device_ms']:.3f} ms {v['kernels']:.1f} k"
             + (f" host {v['host_ms']:.3f}" if "host_ms" in v else "")
             for st, v in s["stages"].items()]
    un = s["unattributed_pct"]
    return ("stages per op: " + "; ".join(parts)
            + f"; no stage {'-' if un is None else f'{un:.3f}'} % of "
            "device time")


def traced_window(lp, kernels: dict, ops: int, device, tries: int = 3):
    """A ``StagedWindow`` of ``ops`` operations of the set-up loop ``lp``,
    taken again (up to ``tries`` windows) while a kernel of ``kernels``
    (label -> name) kept fewer records than the program's counters saw it
    launched, as the harness's traced run does. Returns (the first window
    that kept them all, else the first one, {label: [records, launches]}
    of the window returned)."""
    first = None
    for _ in range(tries):
        before = lp.launches()
        with profiled(device) as got:
            with trace.mark("ngsbench.window"):
                lp.steps(ops, trace.mark)
        after = lp.launches()
        w = got[0]
        kept = {k: [w.recorded(name), after[k] - before[k]]
                for k, name in kernels.items()}
        if all(r >= n for r, n in kept.values()):
            return w, kept
        first = first or (w, kept)
    return first


def measure(cell, seed: int, ops: int, turns: int, device, log) -> dict:
    """``turns`` turns of ``ops`` operations of ``cell``, each untraced,
    then traced; returns the tool's result."""
    lp = cell.loop.setup(cell.config, cell.mix, seed, device, log, False)

    def no_mark(_name):
        return contextlib.nullcontext()

    out = []
    for _ in range(turns):
        t0 = time.perf_counter()
        lp.steps(ops, no_mark)
        untraced = (time.perf_counter() - t0) / ops
        w, kept = traced_window(lp, cell.loop.KERNELS, ops, device)
        s = summary(w, ops)
        log(stage_line(s) + f"; records / launches {kept}")
        out.append({"untraced_ms": untraced * 1e3,
                    "traced_ms": (w.end - w.start) / ops * 1e3,
                    "records": kept} | s)
    lp.release()
    return {"workload": cell.name, "seed": seed, "ops": ops, "turns": out}


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    import torch

    from ngsbench import harness

    t_start = time.perf_counter()

    def log(msg: str):
        t = time.perf_counter() - t_start
        print(f"[ngsbench.stages {t:7.2f} s] {msg}", file=sys.stderr,
              flush=True)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cell = harness.resolve(harness.ROOT, args.workload)
    if not torch.cuda.is_available():
        log(f"cell {args.workload!r} needs a CUDA device; found none")
        return 2
    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, {torch.cuda.get_device_name(device)}")
    result = measure(cell, args.seed, cell.mix["trace_ops"], 3, device,
                     log)
    result["card"] = harness.card_lines(device)
    for line in result["card"]:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
