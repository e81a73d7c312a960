"""PyTorch port vs the JAX package: ``training()`` over a ``Scene``,
checkpoints (the port's own and a JAX one carried across), ``capture`` /
``restore``, the debug snapshot, and the port's train entry point run as a
user runs it.

Both packages train the same 32x32 Blender scene on the scan-oracle
backend ("xla", cheap for JAX to compile), with no density control inside
the window and ``random_background`` off, so the runs differ only by
float rounding.
"""

import copy
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.ops import rasterize as jrast
from neuralgaussiansplatting_tpu.scene import ply as jply
from neuralgaussiansplatting_tpu.scene.scene import Scene as JScene
from neuralgaussiansplatting_tpu.train import loop as jloop
from neuralgaussiansplatting_tpu.train import optim as joptim
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.ops import rasterize as trast
from neuralgaussiansplatting_torch.scene.scene import Scene as TScene
from neuralgaussiansplatting_torch.train import loop as tloop
from neuralgaussiansplatting_torch.train import optim as toptim

from test_scene import _make_blender_scene
from torch_parity import jax_opt_groups

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 8
FLAGS = dict(capacity=8192, max_per_tile=256)


def _scene_dir(root):
    _make_blender_scene(root, n_frames=6, size=32)
    rng = np.random.default_rng(0)
    jply.store_point_cloud(os.path.join(root, "points3d.ply"),
                           rng.normal(size=(200, 3)) * 0.8,
                           rng.random((200, 3)))
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' Scene, Trainer and ``training`` history after ITERS
    iterations from the same files."""
    tmp = tmp_path_factory.mktemp("training")
    src = _scene_dir(str(tmp / "scene"))
    random.seed(0)
    jg = jgm.GaussianModel(sh_degree=3)
    js = JScene(src, str(tmp / "jax"), jg, capacity=512)
    jt = jloop.Trainer(gaussians=jg, opt=joptim.OptimizationParams(),
                       settings=jrast.make_settings("xla", **FLAGS),
                       cameras_extent=js.cameras_extent)
    random.seed(0)
    tg = tgm.GaussianModel(sh_degree=3, device="cpu")
    ts = TScene(src, str(tmp / "port"), tg, capacity=512)
    tt = tloop.Trainer(gaussians=tg, opt=toptim.OptimizationParams(),
                       settings=trast.make_settings("xla", **FLAGS),
                       cameras_extent=ts.cameras_extent)
    jh = jloop.training(js, jt, ITERS, log_every=1)
    th = tloop.training(ts, tt, ITERS, log_every=1)
    return dict(tmp=tmp, js=js, jt=jt, jh=jh, ts=ts, tt=tt, th=th)


def _assert_params_close(t_params, j_params, lrs, steps):
    """``torch_parity.assert_train_step_matches_jax``'s per-leaf gate,
    widened by ``steps``: each element within steps x (2 learning-rate
    steps + 1e-6 of the leaf's largest magnitude), 99 % of elements within
    steps x (1e-5 relative + 1e-7); leaves without a learning rate equal."""
    for field, a, b in zip(jgm.GaussianParams._fields, j_params, t_params):
        a, b = np.asarray(a), b.numpy()
        if field not in lrs:
            np.testing.assert_array_equal(b, a, err_msg=field)
            continue
        diff = np.abs(b - a)
        bound = steps * (2 * lrs[field] * (1 + 1e-5)
                         + 1e-6 * np.abs(a).max())
        assert diff.max() <= bound, (field, diff.max(), bound)
        agree = (diff <= steps * (1e-5 * np.abs(a) + 1e-7)).mean()
        assert agree >= 0.99, (field, agree)


def _lrs(trainer):
    return dict(trainer.tx.lrs, xyz=trainer.tx.lrs["xyz"](0))


def test_training_matches_jax(runs):
    jh, th = runs["jh"], runs["th"]
    assert [m["iter"] for m in th] == list(range(1, ITERS + 1))
    np.testing.assert_allclose([m["loss"] for m in th],
                               [m["loss"] for m in jh], rtol=1e-4)
    for key in ("num_rendered", "dropped", "alive"):
        assert [m[key] for m in th] == [m[key] for m in jh], key
    tt, jt = runs["tt"], runs["jt"]
    assert tt.ts.step == int(jt.ts.step) == ITERS
    _assert_params_close(tt.ts.params, jt.ts.params, _lrs(tt), ITERS)
    np.testing.assert_array_equal(tt.ts.gstate.denom.numpy(),
                                  np.asarray(jt.ts.gstate.denom))
    np.testing.assert_array_equal(tt.ts.gstate.alive.numpy(),
                                  np.asarray(jt.ts.gstate.alive))
    # the models hold the trained state
    assert tt.gaussians.params is tt.ts.params


def _one_step(trainer, scene, iteration):
    cam = scene.get_train_cameras()[0]
    return trainer.step(cam.params("cpu"), torch.from_numpy(cam.image),
                        iteration)


def test_jax_checkpoint_carries_into_port(runs):
    """A JAX ``save_checkpoint`` file, read into the port's Trainer through
    ``params_from_numpy`` / ``opt_state_from_numpy``; then one step on each
    from that state, equal at the single-step gate."""
    jt, js, ts = runs["jt"], runs["js"], runs["ts"]
    path = str(runs["tmp"] / "jax_chkpnt.ckpt")
    jt.save_checkpoint(path, ITERS)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    model = tgm.GaussianModel(sh_degree=3, device="cpu")
    model.active_sh_degree = payload["active_sh_degree"]
    model.spatial_lr_scale = payload["spatial_lr_scale"]
    model.params, model.state = tgm.params_from_numpy(
        payload["params"], payload["gstate"], device="cpu")
    port = tloop.Trainer(gaussians=model, opt=toptim.OptimizationParams(),
                         settings=trast.make_settings("xla", **FLAGS),
                         cameras_extent=ts.cameras_extent)
    port.ts = port.ts._replace(opt_state=tgm.opt_state_from_numpy(
        jax_opt_groups(payload["opt_state"]), device="cpu"),
        step=payload["iteration"])

    before = jt.ts
    cam = js.get_train_cameras()[0]
    j_m = jt.step(cam.params(), np.asarray(cam.image), ITERS + 1)
    after, jt.ts = jt.ts, before
    t_m = _one_step(port, runs["ts"], ITERS + 1)
    np.testing.assert_allclose(t_m["loss"].item(), float(j_m["loss"]),
                               rtol=1e-5)
    _assert_params_close(port.ts.params, after.params, _lrs(port), 1)
    for name, group in port.ts.opt_state.items():
        assert group.count == ITERS + 1, name


def test_checkpoint_round_trip_is_exact(runs):
    """``save_checkpoint`` -> ``restore_checkpoint`` into a fresh Trainer
    gives the same tensors, counts and SH degree, bit for bit, and the next
    step of both is bit-equal."""
    tt, ts = runs["tt"], runs["ts"]
    path = str(runs["tmp"] / "port" / "chkpnt8.ckpt")
    tt.save_checkpoint(path, ITERS)
    model = tgm.GaussianModel(sh_degree=3, device="cpu")
    model.params, model.state = tt.ts.params, tt.ts.gstate
    fresh = tloop.Trainer(gaussians=model, opt=toptim.OptimizationParams(),
                          settings=trast.make_settings("xla", **FLAGS),
                          cameras_extent=ts.cameras_extent)
    fresh.ts = fresh.ts._replace(
        params=tt.ts.params._replace(xyz=torch.zeros_like(tt.ts.params.xyz)),
        step=0)
    assert fresh.restore_checkpoint(path) == ITERS
    assert fresh.ts.step == ITERS
    assert model.active_sh_degree == tt.gaussians.active_sh_degree
    assert model.spatial_lr_scale == tt.gaussians.spatial_lr_scale
    for a, b in zip(list(tt.ts.params) + list(tt.ts.gstate),
                    list(fresh.ts.params) + list(fresh.ts.gstate)):
        assert torch.equal(a, b)
    for name, group in tt.ts.opt_state.items():
        other = fresh.ts.opt_state[name]
        assert torch.equal(group.mu, other.mu) and \
            torch.equal(group.nu, other.nu) and group.count == other.count

    before = tt.ts
    m_a = _one_step(tt, ts, ITERS + 1)
    after, tt.ts = tt.ts, before
    m_b = _one_step(fresh, ts, ITERS + 1)
    assert torch.equal(m_a["loss"], m_b["loss"])
    for a, b in zip(after.params, fresh.ts.params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_capture_restore(runs, source):
    """``restore`` of the port's ``capture`` (through ``torch.save`` and a
    ``weights_only`` load) and of the JAX package's gives the same model."""
    if source == "port":
        want = runs["tt"].gaussians
        path = str(runs["tmp"] / "capture.pt")
        torch.save(want.capture(), path)
        payload = torch.load(path, weights_only=True)
        want_leaves = [t.numpy() for t in list(want.params) + list(want.state)]
    else:
        want = runs["jt"].gaussians
        runs["jt"].sync_model()
        payload = want.capture()
        want_leaves = [np.asarray(a) for a in
                       list(want.params) + list(want.state)]
    model = tgm.GaussianModel(sh_degree=1, device="cpu")
    model.restore(payload)
    assert (model.active_sh_degree, model.max_sh_degree,
            model.spatial_lr_scale) == (want.active_sh_degree,
                                        want.max_sh_degree,
                                        want.spatial_lr_scale)
    for got, expected in zip(list(model.params) + list(model.state),
                             want_leaves):
        np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize("debug_from", [-1, 5, 50])
def test_debug_snapshot_on_non_finite_loss(runs, debug_from, tmp_path):
    """With ``debug`` on (from ``debug_from``), a non-finite loss writes
    the step's inputs and raises; before ``debug_from`` it does not."""
    tt, ts = runs["tt"], runs["ts"]
    trainer = copy.copy(tt)
    trainer.debug, trainer.debug_from = True, debug_from
    trainer.snapshot_dir = str(tmp_path)
    cam = ts.get_train_cameras()[1]
    cp = cam.params("cpu")
    gt = torch.from_numpy(cam.image).clone()
    gt[0, 3, 4] = float("nan")
    path = tmp_path / "snapshot_fw.pt"
    if debug_from > ITERS + 1:
        trainer.grad_step(cp, gt, ITERS + 1)
        assert not path.exists()
        return
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.grad_step(cp, gt, ITERS + 1)
    snap = torch.load(path, weights_only=True)
    assert snap["iteration"] == ITERS + 1
    assert torch.equal(torch.nan_to_num(snap["gt"]), torch.nan_to_num(gt))
    assert torch.equal(snap["cam"]["view"], cp.view)
    assert (snap["cam"]["width"], snap["cam"]["height"]) == (32, 32)
    assert snap["active_sh_degree"] == tt.gaussians.active_sh_degree
    # the inputs of the failing step, which is undone
    assert trainer.ts is tt.ts
    for name, value in tt.ts.params._asdict().items():
        assert torch.equal(snap["params"][name], value), name
    assert torch.equal(snap["gstate"]["alive"], tt.ts.gstate.alive)


def test_train_entry_point_cli(tmp_path):
    """``python -m neuralgaussiansplatting_torch.train`` on the CPU
    (``NGS_PLATFORM=cpu``; the default seq backend, K1/K2's plain
    versions): the files tests/test_cli.py checks for the JAX
    ``train.py``, and the saved PLY, read by the JAX package's
    ``load_ply``, bit-equal to the port's reading and to the checkpoint
    of the same iteration."""
    src = _scene_dir(str(tmp_path / "scene"))
    model = str(tmp_path / "model")
    env = dict(os.environ, NGS_PLATFORM="cpu", OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "neuralgaussiansplatting_torch.train",
         "-s", src, "-m", model, "--eval", "--iterations", "25",
         "--test_iterations", "25", "--save_iterations", "25",
         "--checkpoint_iterations", "25", "--model_capacity", "512",
         "--capacity", "8192", "--disable_viewer", "--quiet"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:{r.stdout[-2000:]}\nSTDERR:{r.stderr[-3000:]}"
    ply = os.path.join(model, "point_cloud", "iteration_25", "point_cloud.ply")
    for name in (ply, "chkpnt25.ckpt", "cfg_args", "cfg_args.json",
                 "cameras.json", "input.ply"):
        assert os.path.exists(os.path.join(model, name)), name

    j_params, j_state, j_deg = jgm.load_ply(ply)
    t_params, t_state, t_deg = tgm.load_ply(ply, device="cpu")
    assert j_deg == t_deg == 3
    for name, a, b in zip(jgm.GaussianParams._fields, j_params, t_params):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    ckpt = torch.load(os.path.join(model, "chkpnt25.ckpt"),
                      weights_only=True)
    assert ckpt["iteration"] == 25
    alive = ckpt["gstate"]["alive"]
    assert int(alive.sum()) == len(j_params.xyz)
    for name, a in zip(jgm.GaussianParams._fields, j_params):
        np.testing.assert_array_equal(
            tgm.normalize_params(tgm.GaussianParams(**ckpt["params"]))
            ._asdict()[name][alive].numpy(), np.asarray(a), err_msg=name)
