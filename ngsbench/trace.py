"""Reading a torch.profiler window: the device's busy intervals, its idle
gaps named by the benchmark's host ranges, kernels by name and the records
each kernel kept.

``kernel_mean_s`` is a copy of the port's mean-record reading
(``utils/timing.kernel_ms``): late in a long process the profiler drops
records, and a mean over what it kept does not read low where a sum does.
``recorded`` counts the records of a kernel, which the caller holds
against the launches the program's counters saw, and a window that kept
fewer is taken again (as the port's ``utils/timing.profiled`` does).
"""

from __future__ import annotations

import contextlib
import dataclasses

RANGE_PREFIX = "ngsbench."


@dataclasses.dataclass
class Window:
    """One profiled window: device intervals (name, start, end) and host
    ranges (name, start, end) in seconds on the trace's clock, and the
    window's own span."""

    device: list
    ranges: list
    start: float
    end: float

    def kernels(self, needle: str) -> list:
        """Durations, in start order, of the device records whose name
        holds ``needle``."""
        return [e - s for n, s, e in sorted(self.device, key=lambda d: d[1])
                if needle in n]

    def recorded(self, needle: str) -> int:
        return len(self.kernels(needle))

    def kernel_count(self) -> int:
        """Kernel records (copies and fills left out)."""
        return sum(1 for n, _, _ in self.device
                   if not n.startswith(("Memcpy", "Memset")))

    def busy(self) -> tuple[float, list]:
        """(seconds in which the device ran something, the idle gaps as
        (start, end)), within the window."""
        spans = sorted((max(s, self.start), min(e, self.end))
                       for _, s, e in self.device if e > self.start
                       and s < self.end)
        busy, gaps, cur = 0.0, [], self.start
        for s, e in spans:
            if s > cur:
                gaps.append((cur, s))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if cur < self.end:
            gaps.append((cur, self.end))
        return busy, gaps

    def host_range_at(self, t: float) -> str:
        """The innermost benchmark range the host was in at ``t``."""
        best, width = "window", float("inf")
        for name, s, e in self.ranges:
            if s <= t < e and e - s < width:
                best, width = name[len(RANGE_PREFIX):], e - s
        return best

    def top_device_ops(self, k: int = 10) -> list:
        """[[name, seconds]] of the ``k`` device operations that took most
        time in the window, summed by name."""
        total = {}
        for n, s, e in self.device:
            total[n] = total.get(n, 0.0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list:
        """[[host range, seconds]] of the ``k`` longest idle gaps."""
        gaps = sorted(self.busy()[1], key=lambda g: g[0] - g[1])[:k]
        return [[self.host_range_at(s), e - s] for s, e in gaps]


def kernel_mean_s(durations: list) -> float | None:
    return sum(durations) / len(durations) if durations else None


def per_op_times(w: Window, kernels: dict, ops: int) -> dict:
    """{label: per-operation durations} of ``kernels`` (label -> name)
    over a window of ``ops`` operations that launch each once, or None
    for a kernel that did not keep one record an operation."""
    out = {}
    for label, name in kernels.items():
        d = w.kernels(name)
        out[label] = d if len(d) == ops else None
    return out


def _device_event(e) -> bool:
    """A kernel, copy or fill on the device (not a range the host opened,
    which the trace repeats on the device's timeline)."""
    from torch.autograd import DeviceType
    if e.device_type != DeviceType.CUDA:
        return False
    if getattr(e, "is_user_annotation", False):
        return False
    return not e.name.startswith((RANGE_PREFIX, "ProfilerStep"))


@contextlib.contextmanager
def profiled(device):
    """A torch.profiler window over the block; yields a list that holds
    the ``Window`` once the block has ended. The block opens its own span
    with ``mark("ngsbench.window")``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = []
    with profile(activities=acts) as prof:
        yield out
    events = prof.events()
    dev, ranges, span = [], [], None
    for e in events:
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if _device_event(e):
            dev.append((e.name, s, t))
        elif (e.name.startswith(RANGE_PREFIX)
              and e.device_type == DeviceType.CPU):
            if e.name == RANGE_PREFIX + "window":
                span = (s, t)
            ranges.append((e.name, s, t))
    if span is None:
        raise RuntimeError("the profiled window has no ngsbench.window span")
    out.append(Window(dev, ranges, span[0], span[1]))


def mark(name: str):
    """A host range the trace records under ``name``."""
    from torch.profiler import record_function
    return record_function(name)
