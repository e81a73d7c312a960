"""The ``Trainer`` schedule, port vs the JAX package.

Both trainers start from the same cloud and run iterations 995..1005 with
small intervals, so that inside eleven steps the SH warm-up fires (at
1000), densification fires three times (996, 1000, 1004; the last one with
the world-size prune), the opacity reset fires (1000) and the capacity
check runs (1000). The scan-oracle backend keeps the JAX side quick to
compile. Gradient threshold 0 makes every visible Gaussian a candidate, so
the clone/split/prune counts are decided by scales and opacities, not by
gradients near a threshold, and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__
from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.ops import rasterize as jrast
from neuralgaussiansplatting_tpu.train import loop as jloop
from neuralgaussiansplatting_tpu.train import optim as joptim
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.ops import rasterize as trast
from neuralgaussiansplatting_torch.train import loop as tloop
from neuralgaussiansplatting_torch.train import optim as toptim

from torch_parity import port_camera, to_torch

torch.set_num_threads(2)

SCHEDULE = dict(densify_from_iter=990, densification_interval=4,
                opacity_reset_interval=1000, densify_until_iter=2000,
                densify_grad_threshold=0.0)
FLAGS = dict(block_x=16, block_y=16, chunk=32, capacity=1 << 12,
             max_per_tile=256)
KW = dict(cameras_extent=1.0, auto_grow=False, tune_interval=1000,
          min_capacity=1 << 12)


def _trainers():
    params, state, cam = __graft_entry__._demo_scene(
        n=40, w=32, h=32, seed=6, capacity=160, sh_degree=3)
    rng = np.random.default_rng(6)
    params = params._replace(scaling=params.scaling + jnp.asarray(
        rng.uniform(-2.5, 0.5, params.scaling.shape).astype(np.float32)))
    jm = jgm.GaussianModel(sh_degree=3)
    jm.params, jm.state = params, state
    tm = tgm.GaussianModel(sh_degree=3, device="cpu")
    tm.params, tm.state = tgm.params_from_numpy(
        jgm.GaussianParams(*map(np.asarray, params)),
        jgm.GaussianState(*map(np.asarray, state)), device="cpu")
    jt = jloop.Trainer(gaussians=jm, opt=joptim.OptimizationParams(**SCHEDULE),
                       settings=jrast.RasterizeSettings(backend="xla", **FLAGS),
                       **KW)
    tt = tloop.Trainer(gaussians=tm, opt=toptim.OptimizationParams(**SCHEDULE),
                       settings=trast.make_settings("xla", **FLAGS), **KW)
    return jt, tt, cam


def _events(trainer, metrics, opacity, alive):
    report = metrics.get("densify")
    op = opacity[alive].max()
    return dict(sh=trainer.gaussians.active_sh_degree,
                densify=None if report is None
                else tuple(int(x) for x in report),
                alive=int(alive.sum()),
                reset=bool(op <= 0.01 + 1e-6),
                retuned="retuned_capacity" in metrics)


def test_trainer_schedule_matches_jax():
    jt, tt, cam = _trainers()
    gt = np.full((3, 32, 32), 0.5, np.float32)
    events = {"jax": [], "port": []}
    for it in range(995, 1006):
        m = jt.step(cam, jnp.asarray(gt), it)
        events["jax"].append(_events(
            jt, m, np.asarray(jax.nn.sigmoid(jt.ts.params.opacity))[:, 0],
            np.asarray(jt.ts.gstate.alive)))
        m = tt.step(port_camera(cam), to_torch(gt), it)
        events["port"].append(_events(
            tt, m, torch.sigmoid(tt.ts.params.opacity)[:, 0].numpy(),
            tt.ts.gstate.alive.numpy()))
    for it, a, b in zip(range(995, 1006), events["jax"], events["port"]):
        assert a == b, (it, a, b)
    fired = {it: e for it, e in zip(range(995, 1006), events["port"])}
    assert [it for it, e in fired.items() if e["densify"]] == [996, 1000,
                                                               1004]
    assert fired[999]["sh"] == 0 and fired[1000]["sh"] == 1
    assert fired[1000]["reset"] and not fired[999]["reset"]
    assert fired[1000]["densify"][1] > 0      # splits happened
    assert tt.ts.step == 11


def test_maybe_grow_doubles_every_per_gaussian_tensor():
    _, tt, cam = _trainers()
    tt.ts = tt.ts._replace(gstate=tt.ts.gstate._replace(
        alive=torch.ones(160, dtype=torch.bool)))
    before = tt.ts
    assert tt.maybe_grow()
    assert tt.ts.params.xyz.shape[0] == 320
    for a, b in zip(before.params, tt.ts.params):
        assert torch.equal(b[:160], a) and b.shape[0] == 320
    assert (tt.ts.params.rotation[160:, 0] == 1).all()
    for name, g in tt.ts.opt_state.items():
        assert g.mu.shape[0] == 320 and not g.mu[160:].any(), name
    assert not tt.ts.gstate.alive[160:].any()
    assert not tt.maybe_grow()


def test_checkpoint_after_growth_restores_at_the_grown_capacity(tmp_path):
    """A checkpoint written after ``maybe_grow`` (as a long run writes one)
    restores at the grown capacity: parameters, state, Adam moments and
    counts as saved, and the restored trainer steps on at that capacity."""
    _, tt, cam = _trainers()
    gt = to_torch(np.full((3, 32, 32), 0.5, np.float32))
    tt.step(port_camera(cam), gt, 1)      # moments and counts past zero
    tt.ts = tt.ts._replace(gstate=tt.ts.gstate._replace(
        alive=tt.ts.gstate.alive | (torch.arange(160) < 140)))
    assert tt.maybe_grow()
    path = str(tmp_path / "chkpnt1.ckpt")
    tt.save_checkpoint(path, 1)
    _, fresh, _ = _trainers()
    assert fresh.restore_checkpoint(path) == 1
    assert fresh.ts.params.xyz.shape[0] == 320
    for a, b in zip(tt.ts.params, fresh.ts.params):
        assert torch.equal(a, b)
    for a, b in zip(tt.ts.gstate, fresh.ts.gstate):
        assert torch.equal(a, b)
    for name, g in tt.ts.opt_state.items():
        h = fresh.ts.opt_state[name]
        assert torch.equal(g.mu, h.mu) and torch.equal(g.nu, h.nu), name
        assert g.count == h.count == 1, name
    m = fresh.step(port_camera(cam), gt, 2)
    assert fresh.ts.params.xyz.shape[0] == 320
    assert np.isfinite(float(m["loss"]))
