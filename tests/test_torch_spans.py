"""The program's stage spans (``utils.timing.span``).

A span is a ``record_function`` only while a profiler records. Under the
CPU profiler a ``Trainer.step`` and a ``render`` nest their spans as the
stages nest, once each, and each autograd node of the step carries the
sequence number of a forward op inside one of the step's spans, which is
what lets a trace charge backward work to the stage it differentiates.
"""

import pytest
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.train import loop
from neuralgaussiansplatting_torch.utils import timing

NODE_PREFIX = "autograd::engine::evaluate_function: "
SETTINGS = rast.make_settings("seq", capacity=1 << 12)


def test_a_span_records_only_while_a_profiler_records():
    off = timing.span("ngs.step", 7)
    assert off is timing.span("ngs.blend")
    with off:
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.span("ngs.step", 7):
            torch.ones(3).sum()
    names = [e.name for e in prof.events()]
    assert names.count("ngs.step") == 1 and "aten::sum" in names
    assert timing.span("ngs.step") is off


def parent_span(e):
    """The name of the innermost "ngs." span above ``e``, or None."""
    e = e.cpu_parent
    while e is not None and not e.name.startswith("ngs."):
        e = e.cpu_parent
    return e and e.name


@pytest.fixture(scope="module")
def traced_step():
    """The CPU profiler's events of the second of two ``Trainer.step``s on
    a tiny scene."""
    params, state, cam = demo.demo_scene(n=60, w=32, h=32, sh_degree=3,
                                         capacity=64, device="cpu")
    model = gm.GaussianModel(sh_degree=3, device="cpu")
    model.params, model.state = params, state
    trainer = loop.Trainer(gaussians=model, tune_interval=1000,
                           settings=SETTINGS)
    gt = torch.rand(3, 32, 32, generator=torch.Generator().manual_seed(3))
    trainer.step(cam, gt, 15001)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.step(cam, gt, 15002)
    return prof.events()


def test_a_traced_trainer_step_nests_its_spans_once_each(traced_step):
    spans = {e.name: e for e in traced_step if e.name.startswith("ngs.")}
    assert sorted(e.name for e in traced_step
                  if e.name.startswith("ngs.")) == \
        sorted(spans) == ["ngs.backward", "ngs.binning", "ngs.blend",
                          "ngs.loss", "ngs.optimizer", "ngs.preprocess",
                          "ngs.render", "ngs.step"]
    assert parent_span(spans["ngs.step"]) is None
    for name, parent in [("ngs.render", "ngs.step"),
                         ("ngs.preprocess", "ngs.render"),
                         ("ngs.binning", "ngs.render"),
                         ("ngs.blend", "ngs.render"),
                         ("ngs.loss", "ngs.step"),
                         ("ngs.backward", "ngs.step"),
                         ("ngs.optimizer", "ngs.step")]:
        assert parent_span(spans[name]) == parent, name


def test_each_backward_node_has_its_forward_op_inside_a_span(traced_step):
    def node(e):
        while e is not None and not e.name.startswith(NODE_PREFIX):
            e = e.cpu_parent
        return e

    forward = {}
    for e in traced_step:
        if e.sequence_nr >= 0 and node(e) is None:
            forward.setdefault((e.thread, e.sequence_nr), []).append(e)
    nodes = [e for e in traced_step if e.name.startswith(NODE_PREFIX)
             and not e.name.endswith("AccumulateGrad")]
    assert len(nodes) > 20
    owner = {}
    for n in nodes:
        ops = forward.get((n.fwd_thread, n.sequence_nr), [])
        assert ops, n.name
        # the node's own op is the last to start with its number
        fwd = max(ops, key=lambda e: e.time_range.start)
        owner[n.name[len(NODE_PREFIX):]] = parent_span(fwd)
        assert owner[n.name[len(NODE_PREFIX):]] in {
            "ngs.render", "ngs.preprocess", "ngs.binning", "ngs.blend",
            "ngs.loss"}, n.name
    assert owner["_SeqBlendBackward"] == "ngs.blend"
    assert {"ngs.preprocess", "ngs.loss"} <= set(owner.values())


def test_a_traced_render_nests_its_spans_once_each(monkeypatch):
    params, state, cam = demo.demo_scene(n=60, w=32, h=32, sh_degree=3,
                                         capacity=64, device="cpu")
    bg = torch.zeros(3)
    entered = []
    real = torch.autograd.profiler.record_function

    def counted(name, args=None):
        entered.append(name)
        return real(name, args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    with torch.no_grad():
        plain = render(cam, params, state.alive, 3, bg, SETTINGS)["render"]
        assert entered == []
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            traced = render(cam, params, state.alive, 3, bg,
                            SETTINGS)["render"]
    assert torch.equal(plain, traced)
    spans = [e for e in prof.events() if e.name.startswith("ngs.")]
    assert sorted(e.name for e in spans) == sorted(entered) == [
        "ngs.binning", "ngs.blend", "ngs.preprocess", "ngs.render"]
    assert {e.name: parent_span(e) for e in spans} == {
        "ngs.render": None, "ngs.preprocess": "ngs.render",
        "ngs.binning": "ngs.render", "ngs.blend": "ngs.render"}
