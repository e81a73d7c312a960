"""Kernel timing on the card: CUDA events around back-to-back calls, the
device time that torch.profiler records, and the program's stage spans
that a trace carries."""

from __future__ import annotations

import contextlib
import math
import time

import torch
from torch.autograd import profiler as _profiler

# what ``span`` returns while no profiler records
_NO_SPAN = contextlib.nullcontext()

# the host's wait in a profiler window's warm-up step, with the trace on,
# before its lead-in launches (``profiled``)
LEAD_IN_S = 0.005


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of one of ``reps`` back-to-back ``fn`` calls in ms, from
    CUDA events around them: the device's time plus the idle time that the
    host's dispatch leaves between calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_records(events) -> list:
    """The kernels, copies and fills among a profiler's ``key_averages()``.
    A range the host opens (a span of ``span``, a ``record_function``) is
    mirrored on the device's timeline as a user annotation whose own
    device time is its whole elapsed time; those are left out, as torch's
    own table leaves them out."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def kernel_ms(events, reps: int) -> dict:
    """{kernel name: device ms per call} of a profiler window of ``reps``
    calls, from its ``key_averages()``: each kernel's mean recorded time
    times its launches per call, its recorded count over ``reps`` rounded
    up. Late in a long process the profiler drops records in chunks (a K7
    window of ``chip_smoke.py`` kept 23 of a kernel's 50 launches, and
    dropped host launch calls alike; ``PERF.md`` §6), and a sum over
    ``reps`` then reads low; the mean does not, and the rounded-up count
    stays right while fewer than ``reps`` records of a kernel are lost.
    Where a kernel kept fewer than ``reps`` records it reads one launch a
    call, whether it lost them or runs less often; ``short_records`` names
    the kernels that kept fewer than half, whose window is not to be
    read."""
    return {e.key: e.self_device_time_total / e.count
            * math.ceil(e.count / reps) / 1e3
            for e in device_records(events) if e.count}


def kernel_records(events, reps: int) -> dict:
    """{kernel name: (records kept, records expected)} of a profiler window
    of ``reps`` calls: expected is ``reps`` times the launches per call
    that ``kernel_ms`` reads for the kernel."""
    return {e.key: (e.count, math.ceil(e.count / reps) * reps)
            for e in device_records(events) if e.count}


def parts_ms(events, part_of, reps: int) -> tuple[dict, dict, dict]:
    """A profiler window of ``reps`` calls of each of several parts, read
    part by part: ({part: device ms per call}, {part: kernels per call},
    {part: least share of its expected records that one of its kernels
    kept}), each kernel as ``kernel_ms`` and ``kernel_records`` read it
    and given to the part that ``part_of(kernel name)`` names (None: to
    no part). The kernels per call are what the caller holds against the
    launches it knows each part makes: a kernel that lost more than half
    its records still reads its time per call from its mean record, and
    only a kernel launched more than once a call may then read fewer
    launches."""
    ms, kernels, kept = {}, {}, {}
    records = kernel_records(events, reps)
    for key, each in kernel_ms(events, reps).items():
        part = part_of(key)
        if part is None:
            continue
        got, want = records[key]
        ms[part] = ms.get(part, 0.0) + each
        kernels[part] = kernels.get(part, 0) + want // reps
        kept[part] = min(kept.get(part, 1.0), got / want)
    return ms, kernels, kept


def short_records(events, reps: int, share: float = 0.5) -> dict:
    """The kernels of a window of ``reps`` calls that kept fewer than
    ``share`` of their expected records, as ``kernel_records``. Such a
    kernel may have lost most of its records or may run less often than
    once a call; ``kernel_ms`` cannot tell which, so its reading is not
    taken."""
    return {k: (kept, want)
            for k, (kept, want) in kernel_records(events, reps).items()
            if kept < share * want}


def profiled(run, lead_in, settle_s: float = LEAD_IN_S):
    """``key_averages()`` of one torch.profiler window over ``run()``. The
    window opens with a warm-up step, whose records the profiler discards:
    the host waits ``settle_s`` with the trace on, then ``lead_in()`` runs
    and the card is synchronised. Only then does the recorded step start,
    so launches made while the device trace is still starting are not in
    it (a window that began with its first launch lost its first ~27
    records of 50 late in ``chip_smoke.py``; ``PERF.md`` §6). ``run()``
    is followed by a synchronisation inside the window. The step's own
    span, "ProfilerStep*" (on the device's timeline too), is left out."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        time.sleep(settle_s)
        lead_in()
        torch.cuda.synchronize()
        prof.step()
        run()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if not e.key.startswith("ProfilerStep")]


def device_ms(fn, reps: int, warmup: int = 2, tries: int = 5) -> float:
    """Device time of one ``fn`` call in ms: the time of the CUDA kernels
    that torch.profiler records over ``reps`` calls, per call
    (``kernel_ms``), in a window that ``profiled`` opens with ``warmup``
    calls of ``fn``. Unlike ``cuda_ms`` it leaves out the device's idle
    time between launches, which is the host's dispatch of each call where
    a call's kernels are shorter. A window that recorded nothing, or in
    which a kernel kept fewer than half its records (``short_records``),
    is taken again, up to ``tries`` times, before RuntimeError, which
    names each short kernel's (kept, expected) records."""
    def lead_in():
        for _ in range(warmup):
            fn()

    def run():
        for _ in range(reps):
            fn()

    short = {}
    for _ in range(tries):
        events = profiled(run, lead_in)
        short = short_records(events, reps)
        ms = sum(kernel_ms(events, reps).values())
        if ms > 0 and not short:
            return ms
    raise RuntimeError(f"the profiler recorded no window with device time "
                       f"and at least half of each kernel's records in "
                       f"{tries} tries; the last one's short kernels "
                       f"(kept, expected): {short}")


def span(name: str, args=None):
    """A host range ``name`` (``args``, if given, as its text) that a
    torch.profiler trace records, while a profiler records; otherwise one
    shared null context. ``record_function`` costs 8-9 us to enter and
    leave on an H100 machine's host even when no profiler runs; the check
    costs ~0.2 us. The program's spans are named "ngs.<stage>"."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _profiler.record_function(
        name, None if args is None else str(args))
