"""The multi-step dispatch, port vs the JAX package: ``train_steps``,
``Trainer.step_block`` / ``grad_step_block`` / ``apply_schedule_block``, and
the train entry point's ``--steps_per_call``.

The scene of ``tests/test_train.py::test_multi_step_block_matches_per_
iteration`` (four 32x32 cameras, 50 Gaussians at SH 1 in 96 slots, the
pallas backend at chunk 8, densify every 8 from 8) runs through both
packages' ``step_block``; densify's split noise is JAX's, injected into the
port. ``random_background`` stays off (JAX draws a block's backgrounds from
one key, the port from its generator).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.ops import rasterize as jrast
from neuralgaussiansplatting_tpu.parallel import train_step as jpts
from neuralgaussiansplatting_tpu.scene import ply as jply
from neuralgaussiansplatting_tpu.train import loop as jloop
from neuralgaussiansplatting_tpu.train import optim as joptim
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.ops import rasterize as trast
from neuralgaussiansplatting_torch.parallel import train_step as tpts
from neuralgaussiansplatting_torch.train import __main__ as entry
from neuralgaussiansplatting_torch.train import densify as tdens
from neuralgaussiansplatting_torch.train import loop as tloop
from neuralgaussiansplatting_torch.train import optim as toptim

from scenes import make_camera, random_gaussians
from test_scene import _make_blender_scene
from test_torch_training import _assert_params_close, _lrs
from torch_parity import port_camera, to_torch

torch.set_num_threads(2)

ITERS, BLOCK, SEED = 24, 4, 5
SCHEDULE = dict(densify_from_iter=8, densification_interval=8,
                opacity_reset_interval=10_000, densify_until_iter=10_000)
FLAGS = dict(capacity=1 << 12, max_per_tile=256, chunk=8, backend="pallas")


def _scene():
    cams = [make_camera(W=32, H=32, angle=a) for a in (0.0, 0.9, 1.8, 2.7)]
    rng = np.random.default_rng(21)
    gts = [rng.random((3, 32, 32)).astype(np.float32) for _ in cams]
    means, *_ = random_gaussians(n=50, deg=1, seed=22)
    params, state = jgm.create_from_pcd(
        means, np.random.default_rng(22).random((50, 3)),
        np.zeros((50, 3)), 1, capacity=96)
    return cams, gts, params, state


def _port_trainer(params, state):
    model = tgm.GaussianModel(sh_degree=1, device="cpu")
    model.params, model.state = tgm.params_from_numpy(
        jgm.GaussianParams(*map(np.asarray, params)),
        jgm.GaussianState(*map(np.asarray, state)), device="cpu")
    return tloop.Trainer(gaussians=model,
                         opt=toptim.OptimizationParams(**SCHEDULE),
                         settings=trast.RasterizeSettings(**FLAGS),
                         auto_tune_capacity=False, seed=SEED)


def _blocks(cams, gts):
    """(first iteration, camera indices) of each block, the JAX test's
    order."""
    return [(blk * BLOCK + 1, [(blk * BLOCK + j) % 4 for j in range(BLOCK)])
            for blk in range(ITERS // BLOCK)]


def _port_blocks(trainer, cams, gts):
    tcams = [port_camera(c) for c in cams]
    for first, idx in _blocks(cams, gts):
        m = trainer.step_block(
            tpts.stack_cameras([tcams[i] for i in idx]),
            torch.stack([to_torch(gts[i]) for i in idx]), first)
    return m


def _state(trainer):
    return (list(trainer.ts.params) + list(trainer.ts.gstate)
            + [t for g in trainer.ts.opt_state.values()
               for t in (g.mu, g.nu)])


def test_step_block_is_bit_equal_to_steps():
    """The port's blocks of 4 against its own 24 ``Trainer.step``s: the
    densify at 16 and 24 lands on block edges, so every tensor of the
    state, the Adam counts and the last metrics are bit-equal."""
    cams, gts, params, state = _scene()
    tcams = [port_camera(c) for c in cams]
    stepped, blocked = _port_trainer(params, state), \
        _port_trainer(params, state)
    for it in range(1, ITERS + 1):
        m1 = stepped.step(tcams[(it - 1) % 4], to_torch(gts[(it - 1) % 4]),
                          it)
    m2 = _port_blocks(blocked, cams, gts)
    assert stepped.ts.step == blocked.ts.step == ITERS
    for a, b in zip(_state(stepped), _state(blocked)):
        assert torch.equal(a, b)
    for name, g in stepped.ts.opt_state.items():
        assert g.count == blocked.ts.opt_state[name].count == ITERS
    assert "densify" in m1 and m1.keys() == m2.keys()
    for k in m1:
        if k != "densify":
            assert torch.equal(torch.as_tensor(m1[k]),
                               torch.as_tensor(m2[k])), k


def test_step_block_matches_jax(monkeypatch):
    """The port's ``step_block`` against JAX's on the JAX test's scene, at
    ``tests/test_torch_training.py``'s multi-step gate (24 steps); the
    densify rounds draw JAX's split noise."""
    cams, gts, params, state = _scene()
    jm = jgm.GaussianModel(sh_degree=1)
    jm.params, jm.state = params, state
    jt = jloop.Trainer(gaussians=jm, opt=joptim.OptimizationParams(**SCHEDULE),
                       settings=jrast.RasterizeSettings(**FLAGS),
                       auto_tune_capacity=False, seed=SEED)
    for first, idx in _blocks(cams, gts):
        jm_last = jt.step_block(jpts.stack_cameras([cams[i] for i in idx]),
                                jnp.stack([jnp.asarray(gts[i]) for i in idx]),
                                first)

    key = [jax.random.PRNGKey(SEED)]
    densify = tdens.densify_and_prune

    def with_jax_noise(params, *args, **kw):
        key[0], sub = jax.random.split(key[0])
        k1, k2 = jax.random.split(sub)
        shape = params.scaling.shape
        kw["noise"] = (to_torch(jax.random.normal(k1, shape)),
                       to_torch(jax.random.normal(k2, shape)))
        return densify(params, *args, **kw)

    monkeypatch.setattr(tdens, "densify_and_prune", with_jax_noise)
    tt = _port_trainer(params, state)
    tm_last = _port_blocks(tt, cams, gts)
    np.testing.assert_allclose(tm_last["loss"].item(),
                               float(jm_last["loss"]), rtol=1e-4)
    assert tt.ts.step == int(jt.ts.step) == ITERS
    np.testing.assert_array_equal(tt.ts.gstate.alive.numpy(),
                                  np.asarray(jt.ts.gstate.alive))
    _assert_params_close(tt.ts.params, jt.ts.params, _lrs(tt), ITERS)


class _Recorder:
    """Stands in for the heavy calls of both packages' block schedule and
    records which fire, with their arguments."""

    def __init__(self):
        self.events = []

    def densify(self, ts, key, extent, *, cfg, use_size_prune):
        self.events.append(("densify", use_size_prune))
        return ts, "report"

    def reset(self, ts):
        self.events.append(("reset",))
        return ts

    def tune(self, settings, num_rendered, aligned_demand, *args):
        self.events.append(("tune", num_rendered))
        return settings, False

    def steps(self, ts, cams, gts, bgs, **kw):
        b = gts.shape[0]
        metrics = {"loss": np.zeros(b, np.float32),
                   "num_rendered": np.full(b, 7), "aligned_demand":
                   np.full(b, 9), "dropped": np.zeros(b, np.int64)}
        self.events.append(("steps", b))
        return ts, metrics


def _schedule_events(loop_mod, trainer, blocks):
    rec = _Recorder()
    saved = {n: getattr(loop_mod, n) for n in
             ("densify_step", "reset_opacity_step", "tune_capacity",
              "train_steps")}
    loop_mod.densify_step, loop_mod.reset_opacity_step = (rec.densify,
                                                          rec.reset)
    loop_mod.tune_capacity, loop_mod.train_steps = rec.tune, rec.steps
    try:
        for it0, it1 in blocks:
            n = it1 - it0 + 1
            m = trainer.grad_step_block(None, np.zeros((n, 3, 2, 2)), it0)
            m = {k: (torch.as_tensor(v) if loop_mod is tloop else v)
                 for k, v in m.items()}
            trainer.apply_schedule_block(it0, it1, m)
            rec.events.append(("sh", trainer.gaussians.active_sh_degree))
    finally:
        for n, f in saved.items():
            setattr(loop_mod, n, f)
    return rec.events


def test_apply_schedule_block_event_edges_match_jax():
    """Blocks of 3 (not a divisor of the intervals) over iterations
    994..1027 with densify every 4 from 996, the opacity reset every 1000,
    the white-background reset at ``densify_from_iter``, tuning every 10
    and the SH warm-up at 1000: both packages fire the same events after
    the same blocks (the size prune once a block ends past 1000)."""
    sched = dict(densify_from_iter=996, densification_interval=4,
                 opacity_reset_interval=1000, densify_until_iter=1020)
    blocks = [(i, min(i + 2, 1027)) for i in range(994, 1028, 3)]
    means, *_ = random_gaussians(n=8, deg=1, seed=1)
    params, state = jgm.create_from_pcd(
        means, np.random.default_rng(1).random((8, 3)), np.zeros((8, 3)),
        1, capacity=8)
    jm = jgm.GaussianModel(sh_degree=1)
    jm.params, jm.state = params, state
    jt = jloop.Trainer(gaussians=jm, opt=joptim.OptimizationParams(**sched),
                       white_background=True, tune_interval=10,
                       auto_grow=False)
    tm = tgm.GaussianModel(sh_degree=1, device="cpu")
    tm.params, tm.state = tgm.params_from_numpy(
        jgm.GaussianParams(*map(np.asarray, params)),
        jgm.GaussianState(*map(np.asarray, state)), device="cpu")
    tt = tloop.Trainer(gaussians=tm, opt=toptim.OptimizationParams(**sched),
                       white_background=True, tune_interval=10,
                       auto_grow=False)
    want = _schedule_events(jloop, jt, blocks)
    got = _schedule_events(tloop, tt, blocks)
    assert got == want
    kinds = {e[0] for e in got}
    assert {"densify", "reset", "tune"} <= kinds
    assert ("densify", True) in got and ("sh", 1) in got


def _scene_dir(root):
    _make_blender_scene(root, n_frames=6, size=32)
    rng = np.random.default_rng(0)
    jply.store_point_cloud(os.path.join(root, "points3d.ply"),
                           rng.normal(size=(200, 3)) * 0.8,
                           rng.random((200, 3)))
    return root


def test_entry_point_steps_per_call_is_bit_equal(tmp_path, monkeypatch):
    """``python -m neuralgaussiansplatting_torch.train``'s ``main`` with
    ``--steps_per_call 4`` and with 1, 16 iterations on the CPU, densify
    and tuning every 8 (block edges), evaluated at the end: the saved PLY
    and checkpoint are bit-equal."""
    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    src = _scene_dir(str(tmp_path / "scene"))
    files = {}
    for spc in (1, 4):
        out = str(tmp_path / f"out{spc}")
        summary = entry.main(
            ["-s", src, "-m", out, "--eval", "--iterations", "16",
             "--densify_from_iter", "4", "--densification_interval", "8",
             "--tune_interval", "8", "--test_iterations", "16",
             "--save_iterations", "16", "--checkpoint_iterations", "16",
             "--model_capacity", "512", "--capacity", "8192",
             "--steps_per_call", str(spc), "--disable_viewer", "--quiet"])
        assert [it for it, _ in summary["tune"]] == [8, 16]
        with open(os.path.join(out, "point_cloud", "iteration_16",
                               "point_cloud.ply"), "rb") as f:
            files[spc] = f.read()
        files[spc, "ckpt"] = torch.load(os.path.join(out, "chkpnt16.ckpt"),
                                        weights_only=True)
    assert files[1] == files[4]
    a, b = files[1, "ckpt"], files[4, "ckpt"]
    for group in ("params", "gstate"):
        for name, value in a[group].items():
            assert torch.equal(value, b[group][name]), name


def test_entry_point_refuses_data_parallel_with_steps_per_call():
    with pytest.raises(SystemExit, match="--data_parallel and "
                       "--steps_per_call are mutually exclusive"):
        entry.main(["-s", "unused", "--data_parallel", "2",
                    "--steps_per_call", "2"])
