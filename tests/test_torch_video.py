"""``utils/video.render_video_frames``, port vs the JAX package, at 16x16
with full-width decoders (JAX's ``init_decoders(PRNGKey(0))`` carried by
``nets_from_flax``) and seeded features, from two cameras: the same frame
files in every mode (rgb, depth, colmap), each frame as ``read_png``
decodes it within 1 level of the JAX package's Pillow-written one, and the
archives' arrays within the gate of ``tests/test_torch_neural_render.py``.

The JAX render paths are jitted (eager, the first costs ~20 s of op
compiles here); jitted XLA moves the feature map by up to ~2e-6.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu import gaussian_renderer as jgr
from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.train import neural_loop as jnl
from neuralgaussiansplatting_tpu.utils import video as jvideo
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.scene.image_io import read_png
from neuralgaussiansplatting_torch.utils import video as tvideo

from scenes import make_camera, random_gaussians
from torch_parity import port_camera, port_decoders, port_model

torch.set_num_threads(2)

MODES = ("rgb", "depth", "colmap")


@pytest.fixture(scope="module")
def inputs():
    means = random_gaussians(n=30, deg=0, seed=0)[0]
    params, state = jgm.create_from_pcd(
        means, np.random.default_rng(1).random((30, 3)), np.zeros((30, 3)),
        0, capacity=32)
    params = params._replace(features=jnp.asarray(np.random.default_rng(
        2).normal(size=(32, 64)).astype(np.float32)))
    cams = [make_camera(W=16, H=16, angle=a) for a in (0.0, 0.7)]
    return params, state, cams, jax.jit(jgr.init_decoders)(
        jax.random.PRNGKey(0))


@pytest.mark.parametrize("sw", [1, 2, 3])
def test_video_frames_match_jax(inputs, sw, tmp_path, monkeypatch):
    params, state, cams, jnet = inputs
    monkeypatch.setitem(jnl.RENDER_FNS, sw, jax.jit(jnl.RENDER_FNS[sw]))
    jmodel = jgm.GaussianModel(0)
    jmodel.params, jmodel.state = params, state
    jscene = types.SimpleNamespace(get_video_cameras=lambda scale=1.0: [
        types.SimpleNamespace(params=lambda cam=cam: cam) for cam in cams])
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jvideo.render_video_frames(jscene, jmodel, jnet, 10, jdir, sw=sw,
                                      modes=MODES, archive_every=1)

    tmodel = tgm.GaussianModel(0, device="cpu")
    tmodel.params, tmodel.state = port_model(params, state)
    tcams = [port_camera(cam) for cam in cams]
    tscene = types.SimpleNamespace(get_video_cameras=lambda scale=1.0: [
        types.SimpleNamespace(params=lambda device, cam=cam: cam)
        for cam in tcams])
    got = tvideo.render_video_frames(tscene, tmodel, port_decoders(jnet), 10,
                                     tdir, sw=sw, modes=MODES,
                                     archive_every=1)
    assert [os.path.relpath(p, tdir) for p in got] == [
        os.path.relpath(p, jdir) for p in want]
    assert len(got) == len(MODES) * len(cams)

    differ = total = 0
    for g, w in zip(got, want):
        g_img, w_img = read_png(g), read_png(w)
        assert g_img.shape == w_img.shape == (16, 16, 3), g
        diff = np.abs(g_img.astype(np.int16) - w_img.astype(np.int16))
        assert diff.max() <= 1, (g, diff.max())
        differ += int((diff > 0).sum())
        total += diff.size
    print(f"sw {sw}: {differ / total:.6f} of the frame values differ")

    for fi in range(len(cams)):
        name = os.path.join("video", "iter_10", f"archive_{fi:04d}.npz")
        with np.load(os.path.join(jdir, name)) as w, \
                np.load(os.path.join(tdir, name)) as g:
            assert sorted(g.files) == sorted(w.files)
            assert "featuremap" in g.files and ("denoiser" in g.files) == (
                sw != 1)
            np.testing.assert_allclose(g["featuremap"], w["featuremap"],
                                       atol=1e-5)
            for key in set(w.files) - {"featuremap"}:
                np.testing.assert_allclose(
                    g[key], w[key], rtol=1e-4,
                    atol=1e-5 * np.abs(w[key]).max(), err_msg=key)
