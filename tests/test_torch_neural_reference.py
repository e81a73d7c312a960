"""The port's neural training step (``neural_train_step``, sw 2) against a
plain float32 PyTorch reference written from the fork's rules
(``ngsbench/reference/neural.py``, the benchmark's) on the CPU: full decoder widths, 64x64 pixels, 2000 Gaussians with seeded
features, seeded decoders.

Tolerances, each with its reading on this scene (float32 port / bfloat16
decoders):

- the z-buffer's winners are equal at every pixel (both take the same
  float32 footprints and break ties by id);
- the loss within 1e-5 of the reference's, relative (0 / 6.5e-4);
- each leaf's first gradient within 1e-4 of the largest magnitude of the
  reference's gradient of that leaf (5.1e-7 / 3.7e-3 to 9.7e-2): the
  orders of summation differ (the denoiser's taps, SSIM's separable blur,
  the direction's norm), not the rules;
- the Adam update within 1e-6 wherever the reference's gradient is over
  1e-3 of the leaf's root mean square (1.2e-7 / 5.0e-3), and within two
  steps of the rate everywhere: the first update is the rate times the
  gradient's sign, which rounding may flip where the gradient is ~0.
"""

import pytest
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch import gaussian_renderer as gr
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.train import neural_loop as nl
from ngsbench.reference import neural as ref

W = H = 64
CAPACITY = 1 << 16
LR = 0.0025
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-6


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(2)
    params, state, cam = demo.demo_scene(n=2000, w=W, h=H, seed=3,
                                         sh_degree=0, device="cpu")
    g = torch.Generator().manual_seed(4)
    params = params._replace(features=torch.randn(params.features.shape,
                                                  generator=g))
    return params, state, cam, torch.rand(3, H, W, generator=g)


def port_step(scene, mixed_precision):
    """(render2's output, the step's loss, {leaf: first gradient}, {leaf:
    after one update}) of the port, and the initial decoders."""
    params, state, cam, gt = scene
    model = gm.GaussianModel(0, device="cpu")
    model.params, model.state = params, state
    tr = nl.NeuralTrainer(model, sw=2, capacity=CAPACITY, seed=5,
                          mixed_precision=mixed_precision)
    decoders = {k: v.detach().clone()
                for k, v in nl.decoder_leaves(tr.net_params).items()}
    with torch.no_grad():
        out = gr.render2(cam, params, tr.net_params, CAPACITY,
                         alive=state.alive)
    metrics = tr.step(cam, gt)
    g_state, n_state = tr.ts.opt_state
    b1 = tr.txs[0].b1
    grads = {"features": g_state["features"].mu / (1 - b1)}
    grads |= {k: s.mu / (1 - b1) for k, s in n_state.items()}
    after = {"features": tr.ts.params.features}
    after |= {k: v.detach() for k, v in
              nl.decoder_leaves(tr.ts.net_params).items()}
    return out, float(metrics["loss"]), grads, after, decoders


def gaps(scene, mixed_precision):
    """The port's step against the reference's: (idxmaps equal, loss gap,
    worst gradient gap, worst update gap on clear gradients, worst update
    gap anywhere)."""
    params, _, cam, gt = scene
    out, loss, grads, after, decoders = port_step(scene, mixed_precision)
    want = ref.steps(params.xyz, params.features, decoders, [cam], [gt],
                     lr=LR)
    assert set(want["grad"]) == set(grads) == set(after)
    same_idx = torch.equal(out["idxmap"].reshape(-1).long(), want["idx"][0])
    loss_gap = abs(loss - want["loss"][0]) / abs(want["loss"][0])
    grad_gap = update_gap = update_any = 0.0
    for k, g in want["grad"].items():
        scale = float(g.abs().max())
        if scale == 0.0:        # the decoders render2 does not use
            assert float(grads[k].abs().max()) == 0.0, k
            assert torch.equal(after[k], decoders[k]), k
            continue
        grad_gap = max(grad_gap, float((grads[k] - g).abs().max()) / scale)
        d = (after[k] - want["params"][k]).abs()
        clear = g.abs() > 1e-3 * g.pow(2).mean().sqrt()
        update_gap = max(update_gap, float(d[clear].max()))
        update_any = max(update_any, float(d.max()))
    return same_idx, loss_gap, grad_gap, update_gap, update_any


def test_the_step_matches_the_plain_reference(scene):
    same_idx, loss_gap, grad_gap, update_gap, update_any = gaps(scene, False)
    assert same_idx
    assert loss_gap <= LOSS_RTOL
    assert grad_gap <= GRAD_TOL
    assert update_gap <= UPDATE_TOL
    assert update_any <= 2 * LR * (1 + 1e-4)


def test_bfloat16_decoders_fail_the_tolerances(scene):
    same_idx, loss_gap, grad_gap, update_gap, _ = gaps(scene, True)
    assert same_idx                  # the z-buffer stays float32
    assert loss_gap > LOSS_RTOL
    assert grad_gap > GRAD_TOL
    assert update_gap > UPDATE_TOL


def test_the_reference_zbuffer_by_hand():
    """Points over the image's centre: the nearer wins its pixels; of two
    at one place the lower id; a point behind the near plane or with its
    centre off screen is not drawn."""
    cam = demo.demo_camera(32, 32, device="cpu")    # at z = -4, facing +z
    pts = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, -0.5], [0.0, 0.0, -0.5],
                        [0.0, 0.0, -3.9], [50.0, 0.0, 0.0]])
    depth, x0, y0, x1, y1, drawn = ref.footprints(pts, cam)
    assert drawn.tolist() == [True, True, True, False, False]
    idx, _, counts = ref.zbuffer(pts, cam)
    covered = torch.zeros(32, 32, dtype=torch.bool)
    covered[int(y0[1]):int(y1[1]), int(x0[1]):int(x1[1])] = True
    assert torch.equal(idx.reshape(32, 32) == 1, covered)
    assert int(covered.sum()) == 9           # radius 3 / 3.5 px
    assert not bool(((idx == 0) | (idx == 2)).any())
    assert counts == {"pairs": 3 * 9, "instances": 3, "tiles": 1,
                      "pixels": 32 * 32}
