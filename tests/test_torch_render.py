"""The forward render slice end to end: port vs the JAX package.

The JAX demo cloud (with random SH and scales) is carried into the port by
``params_from_numpy`` and rendered by both ``gaussian_renderer.render``s.
Images agree to atol 1e-4 (preprocess ulps of two frameworks) and the
binning monitors are equal. Also: the port never imports JAX.
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from neuralgaussiansplatting_tpu import gaussian_renderer as jrender
from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.ops import rasterize as jrast
from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch import gaussian_renderer as trender
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.ops import rasterize as trast

from torch_parity import port_camera

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_FLAGS = dict(capacity=1 << 13, max_per_tile=1024, fast_sort=True,
                   tight_culling=True, precise_cull=True,
                   packed_capacity=1 << 12)
MONITORS = ("num_rendered", "max_per_tile", "aligned_demand", "dropped",
            "culled")

_jax_render = jax.jit(jrender.render, static_argnums=(3, 5),
                      static_argnames=("scaling_modifier",
                                       "convert_shs_python",
                                       "compute_cov3d_python"))


def _scene(n=400, seed=0):
    """The JAX demo cloud at 64x64, SH3, with random SH rest and scales."""
    params, state, cam = __graft_entry__._demo_scene(n=n, w=64, h=64,
                                                     seed=seed, sh_degree=3)
    rng = np.random.default_rng(seed + 100)
    params = params._replace(
        features_rest=jnp.asarray(rng.normal(
            0, 0.2, params.features_rest.shape).astype(np.float32)),
        scaling=params.scaling + jnp.asarray(rng.uniform(
            -0.5, 1.0, params.scaling.shape).astype(np.float32)),
        opacity=jnp.asarray(rng.normal(
            0, 1.5, params.opacity.shape).astype(np.float32)))
    t_params, t_state = tgm.params_from_numpy(
        jgm.GaussianParams(*map(np.asarray, params)),
        jgm.GaussianState(*map(np.asarray, state)), device="cpu")
    return (params, state), (t_params, t_state), cam


@pytest.mark.parametrize("backend", ["seq", "xla"])
def test_render_matches_jax_render(backend):
    (jp, js), (tp, ts), cam = _scene()
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    want = _jax_render(cam, jp, js.alive, 3, jnp.asarray(bg),
                       jrast.make_settings(backend, **BENCH_FLAGS))
    got = trender.render(port_camera(cam), tp, ts.alive, 3,
                         torch.from_numpy(bg),
                         trast.make_settings(backend, **BENCH_FLAGS))
    assert got["render"].shape == (3, 64, 64)
    np.testing.assert_allclose(got["render"].numpy(),
                               np.asarray(want["render"]), atol=1e-4)
    np.testing.assert_allclose(got["final_t"].numpy(),
                               np.asarray(want["final_t"]), atol=1e-4)
    assert (got["n_contrib"].numpy()
            == np.asarray(want["n_contrib"])).mean() >= 0.999
    for key in MONITORS + ("radii", "visibility_filter"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert int(want["dropped"]) == 0 and int(want["num_rendered"]) > 0


def test_render_options_match_jax_render():
    """scaling_modifier, means2d_offset, convert_shs_python and
    compute_cov3d_python (the precomputed-input paths), then override_color,
    on the scan-oracle backend."""
    (jp, js), (tp, ts), cam = _scene(n=200, seed=5)
    offset = np.random.default_rng(6).normal(
        0, 0.01, (200, 2)).astype(np.float32)
    bg = np.array([0.4, 0.1, 0.0], np.float32)
    settings_j = jrast.make_settings("xla", **BENCH_FLAGS)
    settings_t = trast.make_settings("xla", **BENCH_FLAGS)
    colors = np.random.default_rng(7).random((200, 3)).astype(np.float32)
    for kw in (dict(convert_shs_python=True, compute_cov3d_python=True),
               dict(override_color=colors)):
        want = _jax_render(
            cam, jp, js.alive, 3, jnp.asarray(bg), settings_j,
            scaling_modifier=0.8, means2d_offset=jnp.asarray(offset),
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
        got = trender.render(
            port_camera(cam), tp, ts.alive, 3, torch.from_numpy(bg),
            settings_t, scaling_modifier=0.8,
            means2d_offset=torch.from_numpy(offset),
            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
        np.testing.assert_allclose(got["render"].numpy(),
                                   np.asarray(want["render"]), atol=1e-4)
        for key in MONITORS + ("radii",):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), err_msg=key)
        np.testing.assert_array_equal(got["viewspace_points"].numpy(), offset)


def test_mark_visible_matches_jax():
    (jp, _), (tp, _), cam = _scene(n=200, seed=8)
    means = tp.xyz.clone()
    means[:20] = torch.tensor([0.0, 0.0, -5.0])      # behind the camera
    want = jrast.mark_visible(jnp.asarray(means.numpy()), cam)
    got = trast.mark_visible(means, port_camera(cam))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[:20].any() and got[20:].all()


def test_seq_matches_scan_oracle_within_port():
    _, (tp, ts), cam = _scene(n=300, seed=3)
    bg = torch.tensor([0.5, 0.5, 0.5])
    seq = trender.render(port_camera(cam), tp, ts.alive, 3, bg,
                         trast.make_settings("seq", **BENCH_FLAGS))
    xla = trender.render(port_camera(cam), tp, ts.alive, 3, bg,
                         trast.make_settings("xla", block_x=32, block_y=32,
                                             chunk=8, **BENCH_FLAGS))
    np.testing.assert_allclose(seq["render"].numpy(), xla["render"].numpy(),
                               atol=5e-5)
    for key in ("num_rendered", "max_per_tile", "dropped", "culled"):
        assert int(seq[key]) == int(xla[key]), key


def test_demo_camera_orbits_the_origin():
    for angle in (0.0, 0.7, math.pi / 2, 2.5):
        cam = demo.demo_camera(64, 64, angle, device="cpu")
        origin_view = cam.view[:3, 3].numpy()
        np.testing.assert_allclose(origin_view, [0.0, 0.0, 4.0], atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(cam.campos.numpy()), 4.0,
                                   rtol=1e-6)


def test_port_and_chip_smoke_never_import_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import neuralgaussiansplatting_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'neuralgaussiansplatting_tpu')]\n"
        "assert not bad, bad\n"
        "for name in ('ops.blend_seq', 'train.loop', 'train.densify',\n"
        "             'train.optim', 'utils.losses', 'utils.general'):\n"
        "    assert 'neuralgaussiansplatting_torch.' + name in sys.modules\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
