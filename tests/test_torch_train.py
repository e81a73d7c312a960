"""One whole training step, port vs the JAX package, and the model helpers.

``train_step`` on both sides from the same state (the JAX demo cloud with
perturbed opacities and SH, dead padding slots included), seq backend, the
bench's rasterizer flags, L1 + 0.2 (1 - SSIM) against a render of the
unperturbed cloud (rendered by the port, the same numpy image for both).
Loss and PSNR agree to 1e-5. The gradients themselves
(read back from the first Adam moment, mu = 0.1 g) are held at the seq
gradient gate. The parameters after Adam's first step move by
lr * g / (|g| + 1e-15), i.e. by about +-lr per element whatever |g| is, so
an element whose gradient is near zero may step the other way in the other
package: each element is gated at two learning-rate steps of its group, and
at least 99 % of every leaf's elements must agree to 1e-5 relative. Measured
on this scene (CPU): loss 4e-6 relative apart; xyz, features_dc,
features_rest, features, rotation and opacity agree on 100 % of elements,
scaling on 99.90 % (one of 960 elements stepped the other way: 2 lr apart).
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.ops import rasterize as jrast
from neuralgaussiansplatting_tpu.train import optim as joptim
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.ops import rasterize as trast
from neuralgaussiansplatting_torch.train import loop as tloop
from neuralgaussiansplatting_torch.train import optim as toptim

from torch_parity import (assert_train_step_matches_jax, port_camera,
                          to_torch, train_step_inputs)

torch.set_num_threads(2)

N, CAP = 300, 320
FLAGS = dict(capacity=1 << 13, max_per_tile=1024, fast_sort=True,
             tight_culling=True, precise_cull=True)
OPT = joptim.OptimizationParams()
SPATIAL = 1.5


def _step_inputs():
    return train_step_inputs(N, CAP, trast.make_settings("seq", **FLAGS))


def test_train_step_matches_jax():
    assert_train_step_matches_jax(_step_inputs(),
                                  jrast.make_settings("seq", **FLAGS),
                                  trast.make_settings("seq", **FLAGS))


def test_dead_slot_gradients_are_cleared_by_a_select():
    """A NaN gradient in a dead slot (what a degenerate dead row can give)
    must not reach Adam: the step clears it with a select, not a
    multiply."""
    params, state, cam, gt, bg = _step_inputs()
    tp, ts = tgm.params_from_numpy(jgm.GaussianParams(*map(np.asarray, params)),
                                   jgm.GaussianState(*map(np.asarray, state)),
                                   device="cpu")
    # a NaN centre in a dead slot: its rows of the xyz, scaling and
    # rotation gradients come out NaN
    xyz = tp.xyz.clone()
    xyz[CAP - 1] = float("nan")
    tp = tp._replace(xyz=xyz)
    ttx = toptim.make_optimizer(OPT, SPATIAL)
    ts2, m = tloop.train_step(
        tloop.TrainState(tp, ts, ttx.init(tp), 0), port_camera(cam),
        to_torch(gt), to_torch(bg), tx=ttx, sh_degree=3,
        settings=trast.make_settings("seq", **FLAGS), lambda_dssim=0.2)
    assert torch.isfinite(m["loss"])
    for field, group in ts2.opt_state.items():
        assert torch.isfinite(group.mu).all(), field
        assert not group.mu[~ts.alive].any(), field
    for a, b in zip(tp, ts2.params):
        assert torch.equal(a[CAP - 1].isnan(), b[CAP - 1].isnan())
        assert torch.equal(a[CAP - 1].nan_to_num(), b[CAP - 1].nan_to_num())


def test_train_step_marks_its_stages_without_changing_the_step(
        monkeypatch):
    """With no profiler recording, the step's spans enter no
    ``record_function`` and the step is bit-equal to one traced on the
    CPU profiler, which records each stage's span once."""
    params, state, cam, gt, bg = _step_inputs()
    tp, ts = tgm.params_from_numpy(jgm.GaussianParams(*map(np.asarray, params)),
                                   jgm.GaussianState(*map(np.asarray, state)),
                                   device="cpu")
    ttx = toptim.make_optimizer(OPT, SPATIAL)
    entered = []
    real = torch.autograd.profiler.record_function

    def counted(name, args=None):
        entered.append(name)
        return real(name, args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)

    def step():
        return tloop.train_step(
            tloop.TrainState(tp, ts, ttx.init(tp), 0), port_camera(cam),
            to_torch(gt), to_torch(bg), tx=ttx, sh_degree=3,
            settings=trast.make_settings("seq", **FLAGS), lambda_dssim=0.2)

    a, ma = step()
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        b, mb = step()
    stages = ["ngs.render", "ngs.preprocess", "ngs.binning", "ngs.blend",
              "ngs.loss", "ngs.backward", "ngs.optimizer"]
    assert entered == stages
    assert [e.name for e in prof.events() if e.name in stages] == stages
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(a.params + a.gstate, b.params + b.gstate):
        assert torch.equal(x, y)
    for name, g in a.opt_state.items():
        assert torch.equal(g.mu, b.opt_state[name].mu), name
        assert torch.equal(g.nu, b.opt_state[name].nu), name


def test_repad_and_normalize_params():
    params, state, _ = __graft_entry__._demo_scene(n=40, w=32, h=32,
                                                   capacity=48, sh_degree=2)
    tp, ts = tgm.params_from_numpy(jgm.GaussianParams(*map(np.asarray, params)),
                                   jgm.GaussianState(*map(np.asarray, state)),
                                   device="cpu")
    for cap in (64, 40, 48):
        want_p, want_s = jgm.repad(params, state, cap)
        got_p, got_s = tgm.repad(tp, ts, cap)
        for a, b in zip(want_p + want_s, got_p + got_s):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with pytest.raises(ValueError):
        tgm.repad(tp, ts, 32)
    legacy = tp._replace(features_dc=tp.features_dc.reshape(48, 1, 3),
                         features_rest=tp.features_rest.reshape(48, 8, 3))
    flat = tgm.normalize_params(legacy)
    assert torch.equal(flat.features_dc, tp.features_dc)
    assert torch.equal(flat.features_rest, tp.features_rest)


def test_gaussian_model_matches_jax(tmp_path):
    rng = np.random.default_rng(0)

    class Cloud:
        points = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
        colors = rng.random((30, 3)).astype(np.float32)
        normals = np.zeros((30, 3), np.float32)

    jm = jgm.GaussianModel(sh_degree=3)
    jm.create_from_pcd(Cloud, 2.0, capacity=40)
    tm = tgm.GaussianModel(sh_degree=3, device="cpu")
    tm.create_from_pcd(Cloud, 2.0, capacity=40)
    assert (tm.capacity, tm.num_alive) == (jm.capacity, jm.num_alive)
    assert tm.spatial_lr_scale == jm.spatial_lr_scale
    for name, a, b in zip(jgm.GaussianParams._fields, jm.params, tm.params):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    for _ in range(5):
        jm.oneup_sh_degree()
        tm.oneup_sh_degree()
        assert tm.active_sh_degree == jm.active_sh_degree
    path = str(tmp_path / "cloud.ply")
    tm.save_ply(path)
    back = tgm.GaussianModel(sh_degree=0, device="cpu")
    back.load_ply(path, capacity=40)
    assert back.max_sh_degree == back.active_sh_degree == 3
    assert back.num_alive == 30
    for a, b in zip(tm.params, back.params):
        assert torch.equal(a, b)
