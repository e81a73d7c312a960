"""``utils.timing.kernel_ms``, the device time per call that
``chip_smoke.py`` reads from a profiler window, on recorded windows made up
here: the profiler may drop chunks of a kernel's records, and the time per
call must not read low for that; a host range that the trace mirrors on
the device's timeline is no kernel."""

import types

import pytest
import torch

from neuralgaussiansplatting_torch.utils import timing

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def event(key, count, us_each, device=CUDA):
    return types.SimpleNamespace(key=key, count=count, device_type=device,
                                 self_device_time_total=count * us_each,
                                 is_user_annotation=False)


@pytest.mark.parametrize("kept", [50, 49, 28, 1])
def test_one_kernel_a_call_reads_its_time_whatever_was_dropped(kept):
    got = timing.kernel_ms([event("k7::floor_kernel()", kept, 0.87),
                            event("cudaLaunchKernel", 50, 0.0, CPU)], 50)
    assert got == {"k7::floor_kernel()": pytest.approx(0.87e-3)}


@pytest.mark.parametrize("kept", [100, 75, 51])
def test_a_kernel_launched_twice_a_call_counts_twice(kept):
    got = timing.kernel_ms([event("fill", 50, 1.0),
                            event("blend", kept, 10.0)], 50)
    assert sum(got.values()) == pytest.approx((1.0 + 2 * 10.0) / 1e3)


def test_an_empty_window_reads_nothing():
    assert timing.kernel_ms([event("aten::empty", 50, 0.0, CPU)], 50) == {}


@pytest.mark.parametrize("mirror", ["ngs.render", "train_loop"])
def test_a_host_range_mirrored_on_the_device_is_no_kernel(mirror):
    # the trace repeats each host range on the device's timeline, its
    # whole elapsed time as its own device time
    kernel = event("blend", 50, 10.0)
    window = [kernel, types.SimpleNamespace(
        key=mirror, count=50, device_type=CUDA, is_user_annotation=True,
        self_device_time_total=50 * 900.0)]
    assert timing.device_records(window) == [kernel]
    assert timing.kernel_ms(window, 50) == {"blend": pytest.approx(0.01)}
    assert timing.kernel_records(window, 50) == {"blend": (50, 50)}
    assert timing.short_records(window[1:], 100) == {}


@pytest.mark.parametrize("kept, short", [
    (50, {}), (25, {}), (24, {"blend": (24, 50)}), (1, {"blend": (1, 50)}),
    (51, {}), (100, {})])
def test_short_records_names_a_kernel_that_kept_under_half(kept, short):
    window = [event("fill", 50, 1.0), event("blend", kept, 10.0),
              event("cudaLaunchKernel", 3, 0.0, CPU)]
    assert timing.short_records(window, 50) == short


class RecordedWindows:
    """A stand-in for torch.profiler.profile whose windows are ``queue``'s,
    one for each ``with``."""
    queue: list = []

    def __init__(self, activities, schedule):
        self.steps = 0

    def step(self):
        self.steps += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        assert self.steps == 1, "read before the recorded step"
        return RecordedWindows.queue.pop(0)


@pytest.fixture
def recorded(monkeypatch):
    import torch.profiler
    monkeypatch.setattr(torch.profiler, "profile", RecordedWindows)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    RecordedWindows.queue = []
    return RecordedWindows.queue


def test_device_ms_takes_a_short_window_again(recorded):
    recorded += [[event("blend", 20, 10.0)], [event("blend", 50, 2.0)]]
    assert timing.device_ms(lambda: None, reps=50) == pytest.approx(2e-3)
    assert recorded == []


def test_device_ms_refuses_a_kernel_launched_under_once_a_call(recorded):
    # a kernel that runs on one call in five reads as one launch a call by
    # kernel_ms; device_ms names it instead of reading it
    recorded += [[event("every_fifth", 10, 3.0)] for _ in range(5)]
    with pytest.raises(RuntimeError, match=r"'every_fifth': \(10, 50\)"):
        timing.device_ms(lambda: None, reps=50)
    assert recorded == []


@pytest.mark.parametrize("lead", [0, 3])
def test_profiled_keeps_only_the_recorded_step(monkeypatch, lead):
    # the warm-up step's launches are not in the window, its run's are
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    x = torch.ones(4)
    calls = []

    def lead_in():
        for _ in range(lead):
            calls.append("lead")
            torch.add(x, 1)

    def run():
        calls.append("run")
        for _ in range(5):
            torch.mul(x, 2)

    counts = {e.key: e.count
              for e in timing.profiled(run, lead_in, settle_s=0.0)}
    assert calls == ["lead"] * lead + ["run"]
    assert counts.get("aten::mul") == 5
    assert "aten::add" not in counts
    assert not [k for k in counts if k.startswith("ProfilerStep")]


def k7_part(key):
    return ("floor" if "floor" in key else "probe" if key.startswith("k7")
            else None if key == "unrelated" else "library")


@pytest.mark.parametrize("kept", [50, 31, 23, 10])
def test_parts_ms_reads_each_part_from_its_mean_records(kept):
    window = [event("k7::roll_bcast_kernel<false>", kept, 1.1),
              event("k7::floor_kernel()", 50, 0.87),
              event("dot_kernel", 48, 1.5), event("reduce_1Block", 50, 1.2),
              event("unrelated", 50, 9.0),
              event("cudaLaunchKernel", 130, 0.0, CPU)]
    ms, kernels, share = timing.parts_ms(window, k7_part, 50)
    assert ms == {"probe": pytest.approx(1.1e-3),
                  "floor": pytest.approx(0.87e-3),
                  "library": pytest.approx(2.7e-3)}
    assert kernels == {"probe": 1, "floor": 1, "library": 2}
    assert share == {"probe": kept / 50, "floor": 1.0, "library": 0.96}


@pytest.mark.parametrize("kept, launches", [(100, 2), (60, 2), (50, 1)])
def test_parts_ms_counts_a_kernel_launched_twice_a_call_by_its_records(
        kept, launches):
    # while it keeps more than half its records a kernel launched twice a
    # call reads two launches; below that it reads one, which the caller
    # refuses against the launches it knows
    ms, kernels, _ = timing.parts_ms([event("copy", kept, 2.0)],
                                     lambda key: "library", 50)
    assert kernels == {"library": launches}
    assert ms == {"library": pytest.approx(launches * 2e-3)}
