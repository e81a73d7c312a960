"""Neural-feature training, port vs the JAX package.

One ``neural_train_step`` (sw=2: z-buffer, UNet, CNN, denoiser, L1+SSIM)
from the same state on both sides, the decoders carrying JAX's weights:
the loss to rtol 1e-5, and the gradients of the features and of every
decoder parameter, read from Adam's first moment (mu = 0.1 g), at the JAX
seq gate (atol 5e-4 x max|g|, rtol 5e-3). Adam's first step moves a
parameter by about +-lr whatever |g| is, so a near-zero gradient that
rounds to the other sign steps the other way: the post-Adam parameters of
two independent backward passes are not compared; the Adam step itself
is checked in ``tests/test_torch_neural_trainer.py``.

Then three ``NeuralTrainer(sw=2)`` steps on both sides from the same
state: Adam's first step moves every decoder weight by about +-lr, which
random full-width decoders turn into a burst of loss at step 2; the loss
is held to JAX's at every step, the burst included: the first to rtol
1e-5, later ones to rtol 1e-3, since from step 2 on the two sides' weights
differ by the +-lr steps of gradients that round to opposite signs
(readings 1.8e-5 and 1.3e-4 at steps 2 and 3). Both tests drive the JAX
step with one optimizer and the same shapes, so it compiles once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from neuralgaussiansplatting_tpu import gaussian_renderer as jgr
from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.train import neural_loop as jnl
from neuralgaussiansplatting_tpu.train import optim as joptim
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.models import nets as tnets
from neuralgaussiansplatting_torch.train import neural_loop as tnl

from torch_parity import (neural_cloud, port_camera, port_decoder_tree,
                          port_decoders, port_model, to_torch)

torch.set_num_threads(2)

OPT = joptim.OptimizationParams()
GATE = (5e-4, 5e-3)
# the JAX step's optimizer: a static argument of its jit, shared by both
# tests so that the step compiles once
JTXS = jnl.make_neural_optimizer(OPT)


def _scene():
    """(camera, JAX params with N(0, 1) features, state, random target)."""
    cam, params, state = neural_cloud(120, 128, seed=3)
    params = params._replace(features=jnp.asarray(np.random.default_rng(
        4).normal(size=(128, 64)).astype(np.float32)))
    gt = np.random.default_rng(5).random((3, 16, 16)).astype(np.float32)
    return cam, params, state, gt


def test_neural_train_step_matches_jax():
    cam, params, state, gt = _scene()
    jnet = jax.jit(jgr.init_decoders)(jax.random.PRNGKey(2))
    jtxs = JTXS
    j_ts = jnl.NeuralTrainState(
        params, jnet, (jtxs[0].init(params), jtxs[1].init(jnet)),
        jnp.asarray(0), state.alive)
    j_ts2, j_m = jnl.neural_train_step(j_ts, cam, jnp.asarray(gt), sw=2,
                                       capacity=4096, txs=jtxs,
                                       lambda_dssim=OPT.lambda_dssim,
                                       dtype=jnp.float32)

    tp, tstate = port_model(params, state)
    net = port_decoders(jnet)
    ttxs = tnl.make_neural_optimizer(OPT, net)
    t_ts = tnl.NeuralTrainState(
        tp, net, (ttxs[0].init(tp), ttxs[1].init(tnl.decoder_leaves(net))),
        0, tstate.alive)
    t_ts2, t_m = tnl.neural_train_step(t_ts, port_camera(cam), to_torch(gt),
                                       sw=2, capacity=4096, txs=ttxs,
                                       lambda_dssim=OPT.lambda_dssim)

    assert t_ts2.step == 1
    np.testing.assert_allclose(t_m["loss"].item(), float(j_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(t_m["psnr"].item(), float(j_m["psnr"]),
                               rtol=1e-5)
    assert t_m["hit_rate"].item() == float(j_m["hit_rate"]) > 0.2
    assert int(t_m["idx_demand"]) == int(j_m["idx_demand"])

    # gradients, through the first moments
    g_state, n_state = j_ts2.opt_state
    want = {"features": np.asarray(
        g_state.inner_states["train"].inner_state[0].mu.features)}
    want.update(port_decoder_tree(n_state[0].mu))
    got = {"features": t_ts2.opt_state[0]["features"].mu.numpy()}
    got.update({k: g.mu.numpy() for k, g in t_ts2.opt_state[1].items()})
    assert set(got) == set(want)
    assert not got["features"][:, :25].any()
    for name, mu in want.items():
        scale = np.abs(mu).max() + 1e-12
        np.testing.assert_allclose(got[name], mu, atol=GATE[0] * scale,
                                   rtol=GATE[1], err_msg=name)
    # decoders the path does not run get no gradient and stay as they are
    assert not any(got[k].any() for k in got if k.startswith("mlp."))
    for a, b in zip(net["mlp"].parameters(),
                    port_decoders(jnet)["mlp"].parameters()):
        assert torch.equal(a, b)


def test_neural_trainer_losses_match_jax_step_by_step(monkeypatch):
    monkeypatch.setattr(jgr, "init_decoders", jax.jit(jgr.init_decoders))
    cam, params, state, gt = _scene()
    jm = jgm.GaussianModel(sh_degree=0)
    jm.params, jm.state = params, state
    jt = jnl.NeuralTrainer(jm, sw=2, capacity=4096)
    jt.txs = JTXS        # its own optimizer, the same transformation
    tm = tgm.GaussianModel(sh_degree=0, device="cpu")
    tm.params, tm.state = port_model(params, state)
    tt = tnl.NeuralTrainer(tm, sw=2, capacity=4096)
    for name, module in tt.net_params.items():
        module.load_state_dict(tnets.nets_from_flax(
            jax.tree.map(np.asarray, jt.net_params[name])))

    want = [float(jt.step(cam, jnp.asarray(gt))["loss"]) for _ in range(3)]
    got = [tt.step(port_camera(cam), to_torch(gt))["loss"].item()
           for _ in range(3)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)
    assert want[1] > 10 * want[0] and got[1] > 10 * got[0]
    assert tt.ts.step == int(jt.ts.step) == 3
