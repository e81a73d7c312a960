"""``rasterize(backend="pallas")``: the port vs the JAX package, forward.

The whole forward path (preprocess -> bin -> K4's plain version ->
assemble) on both packages from the same numpy scene, at the gates of
tests/test_blend_pallas.py: color and final T to atol 5e-5, n_contrib equal
on > 99.9 % of pixels, the binning monitors equal. Then the port's own
mirrors of that file's ``track_contrib=False`` and precise-cull cases.
Gradients are in tests/test_torch_pallas_grad.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.ops import rasterize as jrast
from neuralgaussiansplatting_torch.ops import rasterize as trast

from scenes import make_camera, random_gaussians
from torch_parity import port_camera, to_torch

torch.set_num_threads(2)

MONITORS = ("num_rendered", "max_per_tile", "aligned_demand", "dropped",
            "culled")


def _scene(n, deg, seed, opacity=None):
    arrays = list(random_gaussians(n=n, deg=deg, seed=seed))
    if opacity is not None:
        arrays[3] = np.full_like(arrays[3], opacity)
    return arrays


@functools.lru_cache(maxsize=None)
def _jax_render(settings, w, h, deg):
    cam = make_camera(W=w, H=h)

    def run(means, scales, rot, opac, shs, bg):
        return jrast.rasterize(means, scales, rot, opac, shs, deg, cam, bg,
                               settings)

    return jax.jit(run)


def _port_render(arrays, deg, w, h, bg, **flags):
    return trast.rasterize(*map(to_torch, arrays), deg,
                           port_camera(make_camera(W=w, H=h)), to_torch(bg),
                           trast.RasterizeSettings(**flags))


@pytest.mark.parametrize("flags, scene", [
    # tests/test_blend_pallas.py's PALLAS settings (32x32 tiles, chunk 8)
    (dict(capacity=1 << 12, max_per_tile=128, chunk=8), "default"),
    (dict(block_x=16, block_y=16, capacity=1 << 12, max_per_tile=128,
          chunk=8), "default"),
    (dict(block_x=32, block_y=16, capacity=1 << 12, max_per_tile=128,
          chunk=16), "default"),
    (dict(block_x=16, block_y=16, capacity=1 << 12, max_per_tile=128,
          chunk=8), "early_stop"),
])
def test_pallas_forward_matches_jax_pallas(flags, scene):
    if scene == "early_stop":   # opacity 0.995 forces T < 1e-4 stops
        arrays, deg, bg = _scene(250, 0, 5, 0.995), 0, np.zeros(3, np.float32)
    else:
        arrays, deg = _scene(120, 1, 3), 1
        bg = np.array([0.1, 0.2, 0.3], np.float32)
    flags = dict(flags, backend="pallas")
    want = _jax_render(jrast.RasterizeSettings(**flags), 48, 32, deg)(
        *map(jnp.asarray, arrays), jnp.asarray(bg))
    got = _port_render(arrays, deg, 48, 32, bg, **flags)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               atol=5e-5)
    np.testing.assert_allclose(got.final_t.numpy(), np.asarray(want.final_t),
                               atol=5e-5)
    assert (got.n_contrib.numpy() == np.asarray(want.n_contrib)).mean() \
        > 0.999
    for key in MONITORS:
        assert int(getattr(got, key)) == int(getattr(want, key)), key
    if scene == "early_stop":
        assert (got.final_t.numpy() < 2e-4).any()


def _port_grads(arrays, settings, bg, loss_fn):
    leaves = [to_torch(a).requires_grad_() for a in arrays]
    out = trast.rasterize(*leaves, 1, port_camera(make_camera(W=48, H=32)),
                          to_torch(bg), settings)
    loss_fn(out).backward()
    return out, [leaf.grad.numpy() for leaf in leaves]


def test_pallas_inference_mode_track_contrib_off():
    """track_contrib=False: identical color and final T, zero n_contrib, and
    the backward (which loses its stop at the deepest contributor) gives
    the same gradients (tests/test_blend_pallas.py's case, on the port)."""
    arrays = _scene(80, 1, 11)
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    on = trast.make_settings("pallas", capacity=1 << 12, max_per_tile=128,
                             chunk=8)
    off = dataclasses.replace(on, track_contrib=False)
    gt = torch.zeros((3, 32, 48))

    def loss(out):
        return ((out.color - gt) ** 2).sum()

    out_p, gp = _port_grads(arrays, on, bg, loss)
    out_f, gf = _port_grads(arrays, off, bg, loss)
    assert torch.equal(out_f.color, out_p.color)
    assert torch.equal(out_f.final_t, out_p.final_t)
    assert not out_f.n_contrib.any() and out_p.n_contrib.any()
    for a, b in zip(gp, gf):
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)


def test_precise_cull_is_image_and_grad_exact():
    """The per-instance coverage cull removes only instances whose every
    pixel alpha is below 1/255: on the port, the images and gradients with
    and without it agree at tests/test_blend_pallas.py's gates while the
    instance stream shrinks; the culled image agrees with JAX's."""
    arrays = _scene(300, 1, 21)
    bg = np.zeros(3, np.float32)
    flags = dict(capacity=1 << 14, max_per_tile=512, chunk=8,
                 backend="pallas", tight_culling=True)
    base = trast.RasterizeSettings(**flags)
    cam = port_camera(make_camera(W=64, H=64))

    def run(settings):
        leaves = [to_torch(a).requires_grad_() for a in arrays]
        out = trast.rasterize(*leaves, 1, cam, to_torch(bg), settings)
        (out.color.square().sum() + out.final_t.sum()).backward()
        return out, [leaf.grad.numpy() for leaf in leaves]

    o0, g0 = run(dataclasses.replace(base, precise_cull=False))
    o1, g1 = run(dataclasses.replace(base, precise_cull=True))
    assert int(o1.culled) > 0, "cull removed nothing on a dense scene"
    assert int(o1.aligned_demand) <= int(o0.aligned_demand)
    np.testing.assert_allclose(o1.color.detach().numpy(),
                               o0.color.detach().numpy(), atol=2e-6)
    np.testing.assert_allclose(o1.final_t.detach().numpy(),
                               o0.final_t.detach().numpy(), atol=2e-6)
    for name, a, b in zip(["means", "scales", "rot", "opac", "shs"], g0, g1):
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b, a, atol=2e-5 * scale, rtol=1e-3,
                                   err_msg=name)
    want = _jax_render(jrast.RasterizeSettings(precise_cull=True, **flags),
                       64, 64, 1)(*map(jnp.asarray, arrays), jnp.asarray(bg))
    np.testing.assert_allclose(o1.color.detach().numpy(),
                               np.asarray(want.color), atol=5e-5)
    assert int(o1.culled) == int(want.culled)
