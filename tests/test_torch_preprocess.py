"""PyTorch port vs the JAX package: per-Gaussian preprocess.

Floats agree to rtol/atol 1e-5 (SH colours differ by float32 ulps of
another summation order; the rest is bit-equal on this scene); radii, tile
rects and tile counts are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.ops import preprocess as jpp
from neuralgaussiansplatting_tpu.ops import transforms as jtr
from neuralgaussiansplatting_torch.ops import preprocess as tpp

from scenes import make_camera
from torch_parity import jax_preprocess, port_camera, scene_inputs, to_torch

torch.set_num_threads(2)


def _assert_preprocessed_equal(got, want):
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("deg", [1, 3])
@pytest.mark.parametrize("tight", [False, True])
def test_preprocess_matches_jax(deg, tight):
    cam = make_camera(W=64, H=64)
    arrays = scene_inputs(deg=deg)
    want = jax_preprocess(*map(jnp.asarray, arrays), sh_degree=deg, cam=cam,
                          block_x=32, block_y=32, tight=tight)
    got = tpp.preprocess_gaussians(*map(to_torch, arrays), deg,
                                   port_camera(cam), 32, 32, tight=tight)
    _assert_preprocessed_equal(got, want)
    touched = np.asarray(want.tiles_touched)
    assert (touched[:9] == 0).all() and (touched[9:] > 0).any()


def test_preprocess_precomputed_inputs_match_jax():
    cam = make_camera(W=64, H=48)
    means, scales, rot, opac, shs = scene_inputs(deg=1, seed=8)
    cov6 = np.asarray(jtr.strip_symmetric(jtr.build_covariance_3d(
        jnp.asarray(scales), 1.0, jnp.asarray(rot))))
    rgb = np.random.default_rng(0).random((250, 3)).astype(np.float32)
    f = jax.jit(jpp.preprocess_gaussians,
                static_argnames=("sh_degree", "block_x", "block_y"))
    want = f(*map(jnp.asarray, (means, scales, rot, opac, shs)),
             sh_degree=1, cam=cam, block_x=16, block_y=16,
             scale_modifier=1.0, cov3d_precomp=jnp.asarray(cov6),
             colors_precomp=jnp.asarray(rgb))
    got = tpp.preprocess_gaussians(
        *map(to_torch, (means, scales, rot, opac, shs)), 1, port_camera(cam),
        16, 16, cov3d_precomp=to_torch(cov6), colors_precomp=to_torch(rgb))
    _assert_preprocessed_equal(got, want)
