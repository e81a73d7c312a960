"""PyTorch port vs the JAX package: transforms, projection and SH math.

Same numpy inputs through both; rtol 1e-5, atol 1e-6 (float32 ulps from
different kernels and summation orders).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.ops import projection as jproj
from neuralgaussiansplatting_tpu.ops import sh as jsh
from neuralgaussiansplatting_tpu.ops import transforms as jtr
from neuralgaussiansplatting_torch.ops import projection as tproj
from neuralgaussiansplatting_torch.ops import sh as tsh
from neuralgaussiansplatting_torch.ops import transforms as ttr

from scenes import make_camera
from torch_parity import to_torch

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(port, ref, **kw):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(kw or TOL))


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("normalize", [True, False])
def test_quat_to_rotmat_matches_jax(normalize):
    q = _rng(0).normal(size=(50, 4)).astype(np.float32)
    q[0] = 0.0                                   # exercises the 1e-16 guard
    _close(ttr.quat_to_rotmat(to_torch(q), normalize),
           jtr.quat_to_rotmat(jnp.asarray(q), normalize))


def test_covariance_and_packing_match_jax():
    rng = _rng(1)
    s = rng.uniform(0.05, 2.0, (40, 3)).astype(np.float32)
    q = rng.normal(size=(40, 4)).astype(np.float32)
    cov_t = ttr.build_covariance_3d(to_torch(s), 1.3, to_torch(q))
    cov_j = jtr.build_covariance_3d(jnp.asarray(s), 1.3, jnp.asarray(q))
    _close(cov_t, cov_j)
    six = ttr.strip_symmetric(cov_t)
    _close(six, jtr.strip_symmetric(cov_j))
    np.testing.assert_array_equal(ttr.unstrip_symmetric(six).numpy(),
                                  np.asarray(jtr.unstrip_symmetric(
                                      jnp.asarray(six.numpy()))))
    x = rng.uniform(0.01, 0.99, (30,)).astype(np.float32)
    _close(ttr.inverse_sigmoid(to_torch(x)), jtr.inverse_sigmoid(jnp.asarray(x)))


def test_camera_helpers_match_jax():
    assert tproj.fov2focal(1.1, 640) == jproj.fov2focal(1.1, 640)
    assert tproj.focal2fov(500.0, 480) == jproj.focal2fov(500.0, 480)
    rng = _rng(2)
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    t = rng.normal(size=3)
    np.testing.assert_array_equal(
        tproj.get_world_to_view(R, t, np.array([0.1, 0.0, -0.2]), 1.5),
        jproj.get_world_to_view(R, t, np.array([0.1, 0.0, -0.2]), 1.5))
    np.testing.assert_array_equal(
        tproj.get_projection_matrix(0.01, 100.0, 1.0, 0.8),
        jproj.get_projection_matrix(0.01, 100.0, 1.0, 0.8))


def test_projection_ops_match_jax():
    cam = make_camera(W=64, H=48)
    view, full = np.asarray(cam.view), np.asarray(cam.full_proj)
    rng = _rng(3)
    pts = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    # a point on the camera plane: w ~ 0 takes the 1e-6 magnitude floor
    pts[0] = np.asarray(cam.campos)
    tp, jp = to_torch(pts), jnp.asarray(pts)
    _close(tproj.transform_points_4x3(tp, to_torch(view)),
           jproj.transform_points_4x3(jp, jnp.asarray(view)))
    _close(tproj.transform_points_4x4(tp, to_torch(full)),
           jproj.transform_points_4x4(jp, jnp.asarray(full)))
    ndc_t = tproj.project_points(tp, to_torch(full))
    ndc_j = jproj.project_points(jp, jnp.asarray(full))
    assert np.isfinite(ndc_t.numpy()).all()
    _close(ndc_t, ndc_j)
    _close(tproj.ndc2pix(ndc_t[:, 0], 64), jproj.ndc2pix(ndc_j[:, 0], 64))

    s = rng.uniform(0.02, 0.3, (200, 3)).astype(np.float32)
    q = rng.normal(size=(200, 4)).astype(np.float32)
    cov3 = jtr.build_covariance_3d(jnp.asarray(s), 1.0, jnp.asarray(q))
    f = jproj.fov2focal(2 * math.atan(cam.tan_fovx), 64)
    c2_t = tproj.compute_cov2d(tp, to_torch(cov3), to_torch(view), f, f,
                               cam.tan_fovx, cam.tan_fovy)
    c2_j = jproj.compute_cov2d(jp, cov3, jnp.asarray(view), f, f,
                               cam.tan_fovx, cam.tan_fovy)
    _close(c2_t, c2_j, rtol=1e-5, atol=1e-5)
    c2 = c2_j.__array__()
    conic_t, rad_t, det_t = tproj.conic_and_radius(to_torch(c2))
    conic_j, rad_j, det_j = jproj.conic_and_radius(jnp.asarray(c2))
    _close(conic_t, conic_j)
    _close(det_t, det_j)
    np.testing.assert_array_equal(rad_t.numpy(), np.asarray(rad_j))
    pix = np.asarray(jnp.stack([jproj.ndc2pix(ndc_j[:, 0], 64),
                                jproj.ndc2pix(ndc_j[:, 1], 48)], -1))
    for got, want in zip(
            tproj.tile_rect(to_torch(pix), rad_t, 4, 3, 16, 16),
            jproj.tile_rect(jnp.asarray(pix), rad_j, 4, 3, 16, 16)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", ["flat", "k3"])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg, layout):
    rng = _rng(10 + deg)
    k = (deg + 1) ** 2
    sh = rng.normal(size=(64, k, 3)).astype(np.float32)
    if layout == "flat":
        sh = sh.reshape(64, 3 * k)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    _close(tsh.eval_sh(deg, to_torch(sh), to_torch(dirs)),
           jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))


@pytest.mark.parametrize("deg", [1, 3])
def test_sh_to_rgb_color_matches_jax(deg):
    rng = _rng(20 + deg)
    k = (deg + 1) ** 2
    sh = (rng.normal(size=(32, 3 * k)) * 0.5).astype(np.float32)
    means = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    campos = np.array([0.0, 0.0, -4.0], np.float32)
    means[0] = campos            # a Gaussian at the camera: safe normalize
    got = tsh.sh_to_rgb_color(deg, to_torch(sh), to_torch(means),
                              to_torch(campos))
    assert np.isfinite(got.numpy()).all()
    _close(got, jsh.sh_to_rgb_color(deg, jnp.asarray(sh), jnp.asarray(means),
                                    jnp.asarray(campos)))
    rgb = rng.uniform(0, 1, (10, 3)).astype(np.float32)
    _close(tsh.SH2RGB(tsh.RGB2SH(to_torch(rgb))),
           jsh.SH2RGB(jsh.RGB2SH(jnp.asarray(rgb))))
