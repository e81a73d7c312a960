"""The neural path's stage spans (``utils.timing.span``).

Under the CPU profiler a ``NeuralTrainer(sw=2).step`` opens "ngs.step",
inside it "ngs.render" (with "ngs.zbuffer", "ngs.decoders" and
"ngs.denoise" inside that), "ngs.loss", "ngs.backward" and
"ngs.optimizer", once each; ``render1`` and ``render3`` open theirs. Each
autograd node of the step carries the sequence number of a forward op
inside one of the step's spans, so a trace charges backward work to the
stage it differentiates. A step with the spans recorded is bit-equal to
one without.
"""

import pytest
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch import gaussian_renderer as gr
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.train import neural_loop as nl

NODE_PREFIX = "autograd::engine::evaluate_function: "
W = H = 32
CAPACITY = 1 << 16
STEP_SPANS = {"ngs.step": None, "ngs.render": "ngs.step",
              "ngs.zbuffer": "ngs.render", "ngs.decoders": "ngs.render",
              "ngs.denoise": "ngs.render", "ngs.loss": "ngs.step",
              "ngs.backward": "ngs.step", "ngs.optimizer": "ngs.step"}


def parent_span(e):
    """The name of the innermost "ngs." span above ``e``, or None."""
    e = e.cpu_parent
    while e is not None and not e.name.startswith("ngs."):
        e = e.cpu_parent
    return e and e.name


def trainer(params, state):
    model = gm.GaussianModel(0, device="cpu")
    model.params, model.state = params, state
    return nl.NeuralTrainer(model, sw=2, capacity=CAPACITY, seed=11)


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(2)
    params, state, cam = demo.demo_scene(n=300, w=W, h=H, seed=5,
                                         sh_degree=0, device="cpu")
    g = torch.Generator().manual_seed(6)
    params = params._replace(features=torch.randn(params.features.shape,
                                                  generator=g))
    return params, state, cam, torch.rand(3, H, W, generator=g)


@pytest.fixture(scope="module")
def traced(scene):
    """(the profiler's events of a second step, the traced trainer, an
    untraced one that took the same steps)."""
    params, state, cam, gt = scene
    plain, tr = trainer(params, state), trainer(params, state)
    for t in (plain, tr):
        t.step(cam, gt)
    plain.step(cam, gt)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.step(cam, gt)
    return prof.events(), tr, plain


def test_a_traced_neural_step_nests_its_spans_once_each(traced):
    events = traced[0]
    spans = [e for e in events if e.name.startswith("ngs.")]
    assert sorted(e.name for e in spans) == sorted(STEP_SPANS)
    assert {e.name: parent_span(e) for e in spans} == STEP_SPANS


def test_each_backward_node_has_its_forward_op_inside_a_span(traced):
    events = traced[0]

    def node(e):
        while e is not None and not e.name.startswith(NODE_PREFIX):
            e = e.cpu_parent
        return e

    forward = {}
    for e in events:
        if e.sequence_nr >= 0 and node(e) is None:
            forward.setdefault((e.thread, e.sequence_nr), []).append(e)
    nodes = [e for e in events if e.name.startswith(NODE_PREFIX)
             and not e.name.endswith("AccumulateGrad")]
    assert len(nodes) > 20
    owner = {}
    for n in nodes:
        ops = forward.get((n.fwd_thread, n.sequence_nr), [])
        assert ops, n.name
        # the node's own op is the last to start with its number
        fwd = max(ops, key=lambda e: e.time_range.start)
        owner[n.name[len(NODE_PREFIX):]] = parent_span(fwd)
    assert set(owner.values()) == {"ngs.zbuffer", "ngs.decoders",
                                   "ngs.denoise", "ngs.loss"}
    assert owner["_GatherRowsBackward"] == "ngs.zbuffer"
    assert owner["ConvolutionBackward0"] == "ngs.decoders"


def test_a_traced_step_is_bit_equal_to_an_untraced_one(traced):
    _, tr, plain = traced
    assert tr.ts.step == plain.ts.step == 2
    assert torch.equal(tr.ts.params.features, plain.ts.params.features)
    got, want = (nl.decoder_leaves(t.ts.net_params) for t in (tr, plain))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    (gs, ns), (ws, wn) = tr.ts.opt_state, plain.ts.opt_state
    assert torch.equal(gs["features"].nu, ws["features"].nu)
    for k in wn:
        assert torch.equal(ns[k].mu, wn[k].mu), k


@pytest.mark.parametrize("sw, inner", [
    (1, ["ngs.decoders", "ngs.zbuffer"]),
    (2, ["ngs.decoders", "ngs.denoise", "ngs.zbuffer"]),
    (3, ["ngs.decoders", "ngs.denoise", "ngs.zbuffer"])])
def test_a_traced_neural_render_nests_its_spans(scene, sw, inner):
    params, state, cam, _ = scene
    net = gr.init_decoders(3, device="cpu")
    fn = nl.RENDER_FNS[sw]
    with torch.no_grad():
        plain = fn(cam, params, net, CAPACITY, alive=state.alive)["render"]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            traced = fn(cam, params, net, CAPACITY,
                        alive=state.alive)["render"]
    assert torch.equal(plain, traced)
    spans = [e for e in prof.events() if e.name.startswith("ngs.")]
    assert sorted(e.name for e in spans) == sorted(["ngs.render"] + inner)
    assert {e.name: parent_span(e) for e in spans} == (
        {"ngs.render": None} | {name: "ngs.render" for name in inner})
