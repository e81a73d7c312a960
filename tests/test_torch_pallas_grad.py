"""Rasterizer gradients on the pallas backend: ``torch.autograd`` through the
port (K5's plain version and the exact per-Gaussian reduction) vs
``jax.grad`` through the JAX package (its Pallas kernels in interpret
mode).

Mirrors tests/test_blend_pallas.py::test_pallas_gradients_match_xla, with
its gate (atol 2e-4 * max|g|, rtol 2e-3), with respect to means, scales,
rotations, opacities, SH and ``means2d_offset`` (the densification
statistic). Two static settings, so JAX compiles its gradient twice:
16x16 tiles with chunk 8, and a ``"seq"`` setting with chunk 64, which both
packages route to these kernels at 32x32. The clustered scene's per-tile
cap drops instances, where JAX's ``"auto"`` reduction takes its
drop-tolerant sort.
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
# max_per_tile 96: the spread-out scenes stay under it, the clustered one
# does not
FLAGS = {
    "pallas": dict(backend="pallas", block_x=16, block_y=16,
                   capacity=1 << 13, max_per_tile=96, chunk=8),
    "seq_chunk64": dict(backend="seq", capacity=1 << 13, max_per_tile=128,
                        chunk=64),
}
CAM = make_camera(W=64, H=48)
GT = np.linspace(0, 1, 3 * 48 * 64, dtype=np.float32).reshape(3, 48, 64)
BG = np.array([0.5, 0.3, 0.4], np.float32)


def _loss_terms(color, final_t, gt):
    return ((color - gt) ** 2).sum() + 0.1 * final_t.sum()


@functools.lru_cache(maxsize=None)
def _jax_grad(setting):
    settings = jrast.RasterizeSettings(grad_reduce="auto", **FLAGS[setting])

    def loss(means, scales, rot, opac, shs, off):
        out = jrast.rasterize(means, scales, rot, opac, shs, 1, CAM,
                              jnp.asarray(BG), settings, means2d_offset=off)
        return _loss_terms(out.color, out.final_t, GT), out.dropped

    return jax.jit(jax.grad(loss, argnums=tuple(range(6)), has_aux=True))


@pytest.mark.parametrize("setting, seed, spread", [
    ("pallas", 7, 1.2), ("pallas", 13, 1.2), ("pallas", 21, 0.25),
    ("seq_chunk64", 7, 1.2),
])
def test_pallas_gradients_match_jax_pallas(setting, seed, spread):
    arrays = random_gaussians(n=N, deg=1, seed=seed, spread=spread) + (
        np.zeros((N, 2), np.float32),)
    want, dropped_j = _jax_grad(setting)(*map(jnp.asarray, arrays))
    leaves = [to_torch(a).requires_grad_() for a in arrays]
    out = trast.rasterize(*leaves[:5], 1, port_camera(CAM),
                          torch.from_numpy(BG),
                          trast.RasterizeSettings(**FLAGS[setting]),
                          means2d_offset=leaves[5])
    _loss_terms(out.color, out.final_t, torch.from_numpy(GT)).backward()
    assert int(out.dropped) == int(dropped_j)
    assert (int(out.dropped) > 0) == (spread < 1.0), int(out.dropped)
    for name, a, leaf in zip(NAMES, want, leaves):
        a = np.asarray(a)
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(leaf.grad.numpy(), a, atol=2e-4 * scale,
                                   rtol=2e-3, err_msg=name)
