"""``ngsbench.stages``: the charge of each device record to a program
stage, and the tool that prints a cell's stages.

On the CPU profiler a ``Trainer.step`` charges every aten op to one
stage, backward ops to "<stage>.bwd" through their node's sequence
number. On profiler windows made up here, as ``tests/test_torch_timing.py``
makes its own: a record belongs to the span whose host call launched it,
whenever it runs; the spans' mirrors on the device's timeline add no
kernel and no busy time; an idle gap is labelled by the launch that ends
it; a window whose kernel kept fewer records than launches is taken
again. The tool sets a cell up and reads its stages through the loops
that ``ngsbench.run`` drives: at a small size on the CPU (no device
records, so every stage reads 0 device ms and the share charged to no
stage is None), every span of the kind's operation shows its host time,
and ``main`` refuses to run without a card.
"""

import contextlib
import types

import pytest
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.train import loop
from ngsbench import harness, stages
from ngsbench.tests import tiny

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
MAIN, ENGINE = 1, 2          # the host's thread and autograd's CUDA thread

SPANS = {"train": {"step", "render", "preprocess", "binning", "blend",
                   "loss", "backward", "optimizer"},
         "render": {"render", "preprocess", "binning", "blend"}}


@pytest.mark.parametrize("kind", ["train", "render"])
def test_the_tool_reads_every_span_of_a_cell(tmp_path, monkeypatch, kind):
    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    cell = harness.resolve(tiny.layout(tmp_path), f"tiny.{kind}")
    r = stages.measure(cell, 98765432109876, 2, 1, torch.device("cpu"),
                       lambda m: None)
    (turn,) = r["turns"]
    assert set(turn["stages"]) == SPANS[kind]
    for st in turn["stages"].values():
        assert st["device_ms"] == 0.0 and st["host_ms"] > 0.0
    assert turn["unattributed_pct"] is None and turn["kernels"] == 0
    assert turn["records"] == {k: [0, 0] for k in cell.loop.KERNELS}
    assert turn["untraced_ms"] > 0 and turn["traced_ms"] > 0


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert stages.main(["--workload", "garden840.render", "--seed", "1"]) == 2


def test_a_traced_trainer_step_charges_every_op_to_one_stage():
    params, state, cam = demo.demo_scene(n=60, w=32, h=32, sh_degree=3,
                                         capacity=64, device="cpu")
    model = gm.GaussianModel(sh_degree=3, device="cpu")
    model.params, model.state = params, state
    trainer = loop.Trainer(gaussians=model, tune_interval=1000,
                           settings=rast.make_settings("seq",
                                                       capacity=1 << 12))
    gt = torch.rand(3, 32, 32, generator=torch.Generator().manual_seed(3))
    trainer.step(cam, gt, 15001)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.step(cam, gt, 15002)
    events = prof.events()
    spans = {e.name: e for e in events if e.name.startswith("ngs.")}
    charger = stages.Charger(events)
    step = spans["ngs.step"].time_range
    ops = [e for e in events if e.name.startswith("aten::")
           and step.start <= e.time_range.start < step.end]
    got = {}
    for e in ops:
        got.setdefault(charger.stage(e), []).append(e.name)
    assert None not in got
    assert set(got) >= {"step", "render", "preprocess", "binning", "blend",
                        "loss", "optimizer", "preprocess.bwd", "blend.bwd",
                        "loss.bwd"}
    assert set(got) <= {"step", "render", "preprocess", "binning", "blend",
                        "loss", "optimizer", "backward", "render.bwd",
                        "preprocess.bwd", "blend.bwd", "loss.bwd"}
    # K2's node (its plain version on the CPU) and the ops inside it
    nodes = {e.name: charger.stage(e) for e in events
             if e.name.startswith(stages.NODE_PREFIX)}
    assert nodes[stages.NODE_PREFIX + "_SeqBlendBackward"] == "blend.bwd"
    backward = spans["ngs.backward"].time_range
    for e in ops:
        inside = backward.start <= e.time_range.start < backward.end
        assert charger.stage(e).endswith(".bwd") or not inside or \
            charger.stage(e) == "backward", e.name


def ev(name, start, end, *, dev=CPU, id=0, thread=MAIN, parent=None,
       seq=-1, fwd=0, annotation=False):
    """A profiler event as ``prof.events()`` gives it (times in us)."""
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=dev, id=id, thread=thread, cpu_parent=parent,
        sequence_nr=seq, fwd_thread=fwd, is_user_annotation=annotation,
        is_async=False)


def launch(cid, t, parent, thread=MAIN):
    return ev("cudaLaunchKernel", t, t + 3, id=cid, parent=parent,
              thread=thread)


def kernel(name, cid, start, end):
    return ev(name, start, end, dev=CUDA, id=cid)


def frame_window():
    """Two frames: "ngsbench.frame" (render: preprocess, then blend, whose
    kernel runs after the host has left the span), then "ngsbench.sync";
    the second frame's first kernel ends an idle gap that opened in the
    sync."""
    window = ev("ngsbench.window", 0, 1000)
    out = [window]
    for base in (0, 500):
        frame = ev("ngsbench.frame", base + 10, base + 100, parent=window)
        render = ev("ngs.render", base + 20, base + 90, parent=frame,
                    annotation=True)
        pre = ev("ngs.preprocess", base + 20, base + 40, parent=render,
                 annotation=True)
        op = ev("aten::mul", base + 21, base + 30, parent=pre, seq=5)
        blend = ev("ngs.blend", base + 50, base + 80, parent=render,
                   annotation=True)
        sync = ev("ngsbench.sync", base + 100, base + 480, parent=window)
        out += [frame, render, pre, op, blend, sync,
                launch(base + 1, base + 22, op),
                launch(base + 2, base + 60, blend),
                kernel("pre_kernel", base + 1, base + 120, base + 200),
                # K1 runs on the device long after "ngs.blend" closed
                kernel("K1", base + 2, base + 200, base + 400)]
    return out


def test_a_record_belongs_to_the_span_that_launched_it():
    w = stages.window_of(frame_window())
    assert w.stage_seconds() == {"preprocess": (pytest.approx(160e-6), 2),
                                 "blend": (pytest.approx(400e-6), 2)}
    assert w.host_seconds("ngs.render") == pytest.approx(140e-6)
    s = stages.summary(w, 2)
    assert s["unattributed_pct"] == 0.0
    assert s["stages"]["blend"] == {"device_ms": pytest.approx(0.2),
                                    "kernels": 1.0,
                                    "host_ms": pytest.approx(0.03)}
    assert "blend 0.200 ms 1.0 k host 0.030" in stages.stage_line(s)


def test_span_annotations_add_no_kernel_or_busy_time():
    events = frame_window()
    bare = stages.window_of(events)
    # the trace mirrors each user range on the device's timeline, with
    # or without the annotation flag
    mirrored = events + [
        ev("ngs.render", 30, 450, dev=CUDA, annotation=True),
        ev("ngs.blend", 200, 400, dev=CUDA, annotation=False),
        ev("ngsbench.frame", 10, 470, dev=CUDA, annotation=False)]
    w = stages.window_of(mirrored)
    assert w.kernel_count() == bare.kernel_count() == 4
    assert w.busy() == bare.busy()
    assert w.stage_seconds() == bare.stage_seconds()


def test_an_idle_gap_is_labelled_by_the_launch_that_ends_it():
    gaps = dict((label, round(s * 1e6)) for label, s in
                stages.window_of(frame_window()).idle_gaps())
    # the gap from the first frame's last record (400 us) to the second
    # frame's first (620 us) opened in "sync"; preprocess launched its end
    assert gaps == {"window/ngs.preprocess": 120, "sync/ngs.preprocess": 220,
                    "sync/-": 100}


def test_backward_records_take_their_forward_stage():
    window = ev("ngsbench.window", 0, 1000)
    step = ev("ngsbench.step", 0, 900, parent=window)
    ngs = ev("ngs.step", 1, 890, parent=step, annotation=True)
    binning = ev("ngs.binning", 4, 9, parent=ngs, annotation=True)
    # an op that made no node peeks the number of the next node made
    peek = ev("aten::sort", 5, 8, parent=binning, seq=41)
    blend = ev("ngs.blend", 10, 50, parent=ngs, annotation=True)
    fwd = ev("_SeqBlend", 20, 40, parent=blend, seq=41)
    loss = ev("ngs.loss", 60, 80, parent=ngs, annotation=True)
    mean = ev("aten::mean", 61, 70, parent=loss, seq=42)
    bwd = ev("ngs.backward", 100, 400, parent=ngs, annotation=True)
    # the nodes run on autograd's own thread: no span encloses them there
    n42 = ev(stages.NODE_PREFIX + "MeanBackward0", 110, 150, thread=ENGINE,
             seq=42, fwd=MAIN)
    n41 = ev(stages.NODE_PREFIX + "_SeqBlendBackward", 160, 300,
             thread=ENGINE, seq=41, fwd=MAIN)
    acc = ev("aten::add_", 280, 290, parent=n41, thread=ENGINE)
    leaf = ev(stages.NODE_PREFIX + "torch::autograd::AccumulateGrad", 310,
              320, thread=ENGINE, fwd=MAIN)
    events = [window, step, ngs, binning, peek, blend, fwd, loss, mean, bwd, n42,
              n41, acc, leaf,
              launch(1, 21, fwd), kernel("K1", 1, 30, 60),
              launch(2, 111, n42, ENGINE), kernel("mean_bwd", 2, 115, 120),
              launch(3, 170, n41, ENGINE), kernel("K2", 3, 175, 250),
              launch(4, 282, acc, ENGINE), kernel("add", 4, 285, 290),
              launch(5, 312, leaf, ENGINE), kernel("copy", 5, 313, 316),
              kernel("dropped_launch", 6, 330, 340)]
    w = stages.window_of(events)
    assert [c[0] for c in w.charge] == ["blend", "loss.bwd", "blend.bwd",
                                        "blend.bwd", "backward", None]
    assert stages.summary(w, 1)["unattributed_pct"] == \
        pytest.approx(100 * 10 / (30 + 5 + 75 + 5 + 3 + 10))


class FakeLoop:
    """A set-up loop whose K1 launch counter counts one launch a step."""

    def __init__(self):
        self.k1 = 0

    def launches(self):
        return {"K1": self.k1}

    def steps(self, n, mark):
        self.k1 += n


@pytest.mark.parametrize("kept, want", [([1, 2, 2], (1, [2, 2])),
                                        ([1, 0, 1], (0, [1, 2]))])
def test_a_window_whose_kernel_lost_records_is_taken_again(monkeypatch, kept,
                                                           want):
    windows = []

    @contextlib.contextmanager
    def profiled(_device):
        got = []
        yield got
        records = kept[len(windows)]
        w = types.SimpleNamespace(recorded=lambda name, r=records: r)
        windows.append(w)
        got.append(w)

    monkeypatch.setattr(stages, "profiled", profiled)
    w, records = stages.traced_window(FakeLoop(), {"K1": "K1"}, 2,
                                      torch.device("cpu"))
    assert len(windows) == 3 - (want[0] == 1)
    assert w is windows[want[0]] and records == {"K1": want[1]}
