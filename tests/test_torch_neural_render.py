"""``render1``/``render2``/``render3``, port vs the JAX package, at 32x32
with full-width decoders (JAX's weights through ``nets_from_flax``) and
seeded features: every key of the JAX return dict; the renders to rtol
1e-4 and atol 1e-5 of the output's largest value (float32 convolutions
that sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu import gaussian_renderer as jgr
from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_torch import gaussian_renderer as tgr

from scenes import make_camera, random_gaussians
from torch_parity import port_camera, port_decoders, port_model

torch.set_num_threads(2)


@pytest.mark.parametrize("sw", [1, 2, 3])
def test_render_paths_match_jax(sw):
    """render1/2/3 at 32x32 with full-width decoders (JAX's weights) and
    seeded features: every key of the JAX return dict."""
    cam = make_camera(W=32, H=32)
    means = random_gaussians(n=200, deg=0, seed=8)[0]
    params, state = jgm.create_from_pcd(
        means, np.random.default_rng(1).random((200, 3)), np.zeros((200, 3)),
        0, capacity=224)
    params = params._replace(features=jnp.asarray(np.random.default_rng(
        2).normal(size=(224, 64)).astype(np.float32)))
    jnet = jax.jit(jgr.init_decoders)(jax.random.PRNGKey(1))
    fn = {1: jgr.render1, 2: jgr.render2, 3: jgr.render3}[sw]
    want = jax.jit(fn, static_argnames=("capacity",))(
        cam, params, jnet, capacity=4096, alive=state.alive)

    tp, ts = port_model(params, state)
    tfn = {1: tgr.render1, 2: tgr.render2, 3: tgr.render3}[sw]
    with torch.no_grad():
        got = tfn(port_camera(cam), tp, port_decoders(jnet), capacity=4096,
                  alive=ts.alive)
    assert set(got) == set(want)
    for key in ("idxmap", "visibility_filter", "radii", "num_inst",
                "viewspace_points"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    # jitted JAX: its fused direction normalisation moves the encoding by
    # up to ~2e-6 (the unfused gate, 1e-6, is the render_idxmaps test's)
    np.testing.assert_allclose(got["featuremap"].numpy(),
                               np.asarray(want["featuremap"]), atol=1e-5)
    for key in ("render", "aggregation", "denoiser"):
        if key in want:
            w = np.asarray(want[key])
            np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=key)
    assert got["render"].shape == (3, 32, 32)
