"""Kernel timing on the card: CUDA events around back-to-back calls, and
the device time that torch.profiler records."""

from __future__ import annotations

import torch


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


def device_ms(fn, reps: int, warmup: int = 2, tries: int = 3) -> float:
    """Device time of one ``fn`` call in ms: the time of the CUDA kernels
    that torch.profiler records over ``reps`` calls, over ``reps``. Unlike
    ``cuda_ms`` it leaves out the device's idle time between launches, which
    is the host's dispatch of each call where a call's kernels are
    shorter. The profiler's device trace now and then comes back empty
    after many sessions in one process; a window that recorded nothing is
    taken again, up to ``tries`` times, before RuntimeError."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    raise RuntimeError(f"the profiler recorded no device time in {tries} "
                       "windows")
