"""Rasterizer gradients: ``torch.autograd`` through the port's seq backend
vs ``jax.grad`` through the JAX package's.

Mirrors tests/test_blend_seq.py::test_seq_gradients_match_xla and
``..._xla32_scatter``, with the gradient gate there (atol 5e-4 * max|g|,
rtol 5e-3), with respect to means, scales, rotations, opacities, SH and
``means2d_offset`` (the densification statistic, at the reference's W/2
scale). The port has one exact per-Gaussian reduction; it is held against
the JAX package's ``grad_reduce`` modes, and one scene's per-tile cap drops
instances, so it is held where JAX takes its drop-tolerant sort
(``blend_pallas._reduce_sorted_dropped``).
"""

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

N = 160
NAMES = ("means", "scales", "rot", "opac", "shs", "off")
# max_per_tile 128: the spread-out scenes stay under it, the clustered one
# does not
FLAGS = dict(block_x=32, block_y=32, capacity=1 << 13, max_per_tile=128,
             chunk=128)
CAM = make_camera(W=64, H=64)
GT = np.linspace(0, 1, 3 * 64 * 64, dtype=np.float32).reshape(3, 64, 64)
BG = np.array([0.5, 0.3, 0.4], np.float32)


def _loss_terms(color, final_t, gt, weight_t):
    return ((color - gt) ** 2).sum() + weight_t * final_t.sum()


@functools.lru_cache(maxsize=None)
def _jax_grad(grad_reduce, weight_t):
    settings = jrast.RasterizeSettings(backend="seq", grad_reduce=grad_reduce,
                                       **FLAGS)

    def loss(means, scales, rot, opac, shs, off):
        out = jrast.rasterize(means, scales, rot, opac, shs, 1, CAM,
                              jnp.asarray(BG), settings, means2d_offset=off)
        return _loss_terms(out.color, out.final_t, GT, weight_t), out.dropped

    return jax.jit(jax.grad(loss, argnums=tuple(range(6)), has_aux=True))


def _port_grad(arrays, weight_t):
    leaves = [to_torch(a).requires_grad_() for a in arrays]
    out = trast.rasterize(*leaves[:5], 1, port_camera(CAM),
                          torch.from_numpy(BG),
                          trast.make_settings("seq", **FLAGS),
                          means2d_offset=leaves[5])
    _loss_terms(out.color, out.final_t, torch.from_numpy(GT),
                weight_t).backward()
    return [leaf.grad.numpy() for leaf in leaves], int(out.dropped)


@pytest.mark.parametrize("grad_reduce, seed, spread, weight_t", [
    ("auto", 7, 1.2, 0.1),     # test_seq_gradients_match_xla's loss
    ("scatter", 13, 1.2, 1.0),  # ..._xla32_scatter's loss
    ("auto", 21, 0.25, 0.1),   # clustered: the cap drops instances
])
def test_seq_gradients_match_jax_seq(grad_reduce, seed, spread, weight_t):
    arrays = random_gaussians(n=N, deg=1, seed=seed, spread=spread) + (
        np.zeros((N, 2), np.float32),)
    want, dropped_j = _jax_grad(grad_reduce, weight_t)(
        *map(jnp.asarray, arrays))
    got, dropped = _port_grad(arrays, weight_t)
    assert dropped == int(dropped_j)
    assert (dropped > 0) == (spread < 1.0), dropped
    for name, a, b in zip(NAMES, want, got):
        a = np.asarray(a)
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b, a, atol=5e-4 * scale, rtol=5e-3,
                                   err_msg=name)


def test_offset_gradient_is_the_pixel_gradient_at_half_size():
    """d loss / d means2d_offset == d loss / d (pixel centre) * (W/2, H/2)."""
    arrays = [to_torch(a) for a in random_gaussians(n=50, deg=1, seed=3)]
    cam = port_camera(make_camera(W=64, H=48))
    settings = trast.make_settings("seq", capacity=1 << 13)
    off = torch.zeros((50, 2), requires_grad=True)
    out = trast.rasterize(*arrays, 1, cam, torch.zeros(3), settings,
                          means2d_offset=off)
    out.color.square().sum().backward()
    # the same loss as a function of a pixel-space shift
    shift = torch.zeros((50, 2), requires_grad=True)
    scaled = shift / torch.tensor([32.0, 24.0])
    out2 = trast.rasterize(*arrays, 1, cam, torch.zeros(3), settings,
                           means2d_offset=scaled)
    out2.color.square().sum().backward()
    assert off.grad.abs().max() > 0
    np.testing.assert_allclose(off.grad.numpy(),
                               (shift.grad * torch.tensor([32.0, 24.0])
                                ).numpy(), rtol=1e-5, atol=1e-6)


def test_seq_gradients_match_scan_oracle_within_port():
    """The port's seq backward vs autograd through its own scan oracle
    (32x32 tiles), at the JAX gate."""
    arrays = random_gaussians(n=90, deg=1, seed=13)
    grads = {}
    for backend, chunk in (("seq", 128), ("xla", 8)):
        leaves = [to_torch(a).requires_grad_() for a in arrays]
        settings = trast.make_settings(backend, block_x=32, block_y=32,
                                       chunk=chunk, capacity=1 << 13)
        out = trast.rasterize(*leaves, 1, port_camera(CAM),
                              torch.tensor([0.3, 0.1, 0.2]), settings)
        (out.color.square().sum() + out.final_t.sum()).backward()
        grads[backend] = [leaf.grad.numpy() for leaf in leaves]
    for name, a, b in zip(NAMES, grads["xla"], grads["seq"]):
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b, a, atol=5e-4 * scale, rtol=5e-3,
                                   err_msg=name)
