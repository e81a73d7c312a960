"""The neural path's optimizer and ``NeuralTrainer``, port vs the JAX
package: the same gradients through both packages' Adam, the z-buffer
capacity autotune's cadence, the loss falling over 60 steps (as
``tests/test_neural.py`` checks the JAX trainer) and mixed precision.
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
from neuralgaussiansplatting_torch.train import neural_loop as tnl

from torch_parity import (neural_cloud, port_camera, port_decoder_tree,
                          port_decoders, port_model, to_torch)

torch.set_num_threads(2)

OPT = joptim.OptimizationParams()


def test_neural_adam_step_matches_optax():
    """The same gradients into the JAX package's optimizers and the
    port's: the updated features and decoder parameters agree."""
    _, params, _ = neural_cloud(40, 48, seed=6)
    jnet = jax.jit(jgr.init_decoders)(jax.random.PRNGKey(3))
    rng = np.random.default_rng(7)
    jgrads = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        (params, jnet))
    jtxs = jnl.make_neural_optimizer(OPT)

    @jax.jit
    def jax_adam(params, jnet, grads):
        up_g, _ = jtxs[0].update(grads[0], jtxs[0].init(params), params)
        up_n, _ = jtxs[1].update(grads[1], jtxs[1].init(jnet), jnet)
        return (jax.tree.map(lambda p, u: p + u, params, up_g),
                jax.tree.map(lambda p, u: p + u, jnet, up_n))

    new_params, new_net = jax_adam(params, jnet, jgrads)

    tp, _ = port_model(params, jgm.GaussianState(
        *(np.zeros(48) for _ in jgm.GaussianState._fields)))
    net = port_decoders(jnet)
    leaves = {k: p.detach() for k, p in tnl.decoder_leaves(net).items()}
    ttxs = tnl.make_neural_optimizer(OPT, net)
    got_p, state = ttxs[0].update({"features": to_torch(jgrads[0].features)},
                                  ttxs[0].init(tp), tp)
    got_n, _ = ttxs[1].update(
        {k: to_torch(v) for k, v in port_decoder_tree(jgrads[1]).items()},
        ttxs[1].init(leaves), leaves)
    assert state["features"].count == 1
    np.testing.assert_allclose(got_p.features.numpy(),
                               np.asarray(new_params.features), rtol=1e-6,
                               atol=1e-7)
    for field in jgm.GaussianParams._fields:     # everything else frozen
        if field != "features":
            assert torch.equal(getattr(got_p, field), getattr(tp, field))
    for name, value in port_decoder_tree(new_net).items():
        np.testing.assert_allclose(got_n[name].numpy(), value, rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def _trainer_model(n, capacity, seed):
    cam, params, state = neural_cloud(n, capacity, seed)
    model = tgm.GaussianModel(sh_degree=0, device="cpu")
    model.params, model.state = port_model(params, state)
    return cam, model


def test_neural_trainer_reduces_loss():
    cam, model = _trainer_model(60, 64, seed=9)
    trainer = tnl.NeuralTrainer(model, sw=1, capacity=4096)
    gt = to_torch(np.random.default_rng(10).random(
        (3, 16, 16)).astype(np.float32) * 0.2 + 0.4)
    seen = [trainer.step(port_camera(cam), gt)["loss"].item()
            for _ in range(60)]
    assert np.mean(seen[-5:]) < np.mean(seen[:5]) * 0.8
    trainer.sync_model()
    assert model.params is trainer.ts.params
    assert model.params.features[:, 25:].abs().max() > 0
    assert torch.equal(model.params.xyz, trainer.ts.params.xyz)


def test_neural_trainer_capacity_autotune_follows_jax_cadence(monkeypatch):
    """Steps 99 and 100 from a capacity four times the need: only step 100
    retunes, to the same capacity on both sides."""
    # the JAX trainer's decoders, initialised under jit (eagerly it takes
    # seconds; the values are the same)
    monkeypatch.setattr(jgr, "init_decoders", jax.jit(jgr.init_decoders))
    cam, params, state = neural_cloud(60, 64, seed=11)
    gt = np.full((3, 16, 16), 0.5, np.float32)
    jm = jgm.GaussianModel(sh_degree=0)
    jm.params, jm.state = params, state
    jt = jnl.NeuralTrainer(jm, sw=1, capacity=1 << 20)
    jt.ts = jt.ts._replace(step=jnp.asarray(98))
    _, tm = _trainer_model(60, 64, seed=11)
    tt = tnl.NeuralTrainer(tm, sw=1, capacity=1 << 20)
    tt.ts = tt.ts._replace(step=98)
    for step in (99, 100):
        jmet = jt.step(cam, jnp.asarray(gt))
        tmet = tt.step(port_camera(cam), to_torch(gt))
        assert tt.ts.step == int(jt.ts.step) == step
        assert tmet.get("retuned_idx_capacity") == \
            jmet.get("retuned_idx_capacity")
        assert tt.capacity == jt.capacity
    assert tt.capacity == 1 << 16


def test_neural_trainer_mixed_precision_runs_finite():
    cam, model = _trainer_model(30, 32, seed=12)
    trainer = tnl.NeuralTrainer(model, sw=2, capacity=2048,
                                mixed_precision=True)
    assert trainer.dtype == torch.bfloat16
    metrics = trainer.step(port_camera(cam), torch.full((3, 16, 16), 0.5))
    assert torch.isfinite(metrics["loss"])
    for name, p in tnl.decoder_leaves(trainer.net_params).items():
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), name
    assert torch.isfinite(trainer.ts.params.features).all()
