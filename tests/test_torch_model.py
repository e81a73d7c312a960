"""PyTorch port vs the JAX package: the Gaussian model, PLY interchange,
weights carried across, kNN scale init and the demo scene."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.ops import knn as jknn
import neuralgaussiansplatting_torch
from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.ops import knn as tknn
from neuralgaussiansplatting_torch.ops import preprocess as tpp

torch.set_num_threads(2)


def _jax_model(n=150, deg=3, capacity=200, seed=0):
    """A JAX (params, state) with every leaf randomized, dead slots padded."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    params, state = jgm.create_from_pcd(
        pts, rng.random((n, 3)), rng.normal(size=(n, 3)), deg, capacity)
    noisy = {k: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)
             * (np.arange(v.shape[0]) < n).reshape(-1, *[1] * (v.ndim - 1))
             for k, v in params._asdict().items()}
    return jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in noisy.items()}), state


def _assert_same_model(t_params, t_state, j_params, j_state):
    for name in j_params._fields:
        np.testing.assert_array_equal(getattr(t_params, name).numpy(),
                                      np.asarray(getattr(j_params, name)),
                                      err_msg=name)
        assert getattr(t_params, name).dtype == torch.float32
    for name in j_state._fields:
        np.testing.assert_array_equal(getattr(t_state, name).numpy(),
                                      np.asarray(getattr(j_state, name)),
                                      err_msg=name)


def test_ply_jax_save_port_load(tmp_path):
    params, state = _jax_model()
    path = str(tmp_path / "jax.ply")
    jgm.save_ply(path, params, state.alive)
    t_params, t_state, deg = tgm.load_ply(path, capacity=200, device="cpu")
    j_params, j_state, j_deg = jgm.load_ply(path, capacity=200)
    assert deg == j_deg == 3
    _assert_same_model(t_params, t_state, j_params, j_state)


def test_ply_port_save_jax_load(tmp_path):
    params, state = _jax_model(deg=1, seed=1)
    t_params, t_state = tgm.params_from_numpy(
        jgm.GaussianParams(*map(np.asarray, params)),
        jgm.GaussianState(*map(np.asarray, state)), device="cpu")
    path = str(tmp_path / "port.ply")
    tgm.save_ply(path, t_params, t_state.alive)
    j_params, j_state, j_deg = jgm.load_ply(path, capacity=200)
    alive = np.asarray(state.alive)
    for name in j_params._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(j_params, name))[alive],
            np.asarray(getattr(params, name))[alive], err_msg=name)
    assert j_deg == 1 and (np.asarray(j_state.alive) == alive).all()


@pytest.mark.parametrize("as_dict", [False, True])
def test_params_from_numpy_is_bit_equal(as_dict):
    params, state = jgm.create_from_pcd(
        np.random.default_rng(2).uniform(-1, 1, (90, 3)).astype(np.float32),
        np.random.default_rng(3).random((90, 3)), np.zeros((90, 3)), 2, 128)
    p_np = jgm.GaussianParams(*map(np.asarray, params))
    s_np = jgm.GaussianState(*map(np.asarray, state))
    if as_dict:
        p_np, s_np = p_np._asdict(), s_np._asdict()
    t_params, t_state = tgm.params_from_numpy(p_np, s_np, device="cpu")
    _assert_same_model(t_params, t_state, params, state)
    assert t_state.alive.dtype == torch.bool


def test_activations_match_jax():
    params, state = _jax_model(deg=2, seed=4)
    tp, ts = tgm.params_from_numpy(
        jgm.GaussianParams(*map(np.asarray, params)),
        jgm.GaussianState(*map(np.asarray, state)), device="cpu")
    tp = tp._replace(scaling=tp.scaling + 30.0 * (tp.scaling > 1.5))  # clamp
    params = params._replace(scaling=jnp.asarray(tp.scaling.numpy()))
    tol = dict(rtol=1e-6, atol=1e-7)
    pairs = [
        (tgm.get_scaling(tp), jgm.get_scaling(params)),
        (tgm.get_rotation(tp), jgm.get_rotation(params)),
        (tgm.get_opacity(tp, ts.alive), jgm.get_opacity(params, state.alive)),
        (tgm.get_features(tp), jgm.get_features(params)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(tgm.get_covariance(tp, 0.7).numpy(),
                               np.asarray(jgm.get_covariance(params, 0.7)),
                               rtol=1e-5, atol=1e-6)
    assert not tgm.get_opacity(tp, ts.alive)[150:].any()


def test_knn_and_create_from_pcd_match_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    d_t = tknn.mean_sq_dist_3nn(pts)
    np.testing.assert_allclose(d_t, jknn.mean_sq_dist_3nn(pts), rtol=1e-5)
    np.testing.assert_allclose(tknn._brute_force_3nn(pts), d_t, rtol=1e-5)
    colors = rng.random((300, 3))
    tp, ts = tgm.create_from_pcd(pts, colors, np.zeros((300, 3)), 3, 320,
                                 device="cpu")
    jp, js = jgm.create_from_pcd(pts, colors, np.zeros((300, 3)), 3, 320)
    for name in jp._fields:
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))


def test_demo_scene_matches_jax_demo_scene():
    tp, ts, tcam = demo.demo_scene(n=500, w=64, h=48, seed=7, sh_degree=3,
                                   device="cpu")
    jp, js, jcam = __graft_entry__._demo_scene(n=500, w=64, h=48, seed=7,
                                               sh_degree=3)
    for name in ("xyz", "normals", "features_dc", "features_rest",
                 "rotation", "opacity"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    # kNN through scipy here, the native library there: float32 ulps
    np.testing.assert_allclose(tp.scaling.numpy(), np.asarray(jp.scaling),
                               rtol=1e-5)
    for name in ("view", "full_proj", "campos"):
        np.testing.assert_array_equal(getattr(tcam, name).numpy(),
                                      np.asarray(getattr(jcam, name)))
    for name in ("tan_fovx", "tan_fovy", "width", "height", "limit_x",
                 "limit_y"):
        assert getattr(tcam, name) == getattr(jcam, name), name


def test_entry_points_refuse_missing_gpu(monkeypatch, tmp_path):
    """With no GPU and no device given, entry points raise; they never
    quietly run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eye = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpp.CameraParams(eye, eye, np.zeros(3), 0.5, 0.5, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.demo_scene(n=16, w=8, h=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgm.load_ply(str(tmp_path / "missing.ply"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgm.create_from_pcd(np.zeros((4, 3), np.float32), np.zeros((4, 3)),
                            np.zeros((4, 3)), 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        neuralgaussiansplatting_torch.resolve_device("cuda")
