"""PyTorch port vs the JAX package: tile binning.

Both sides are fed the JAX package's own ``Preprocessed`` (as numpy), so
every ``Instances`` field must be exactly equal, for every expansion, sort
and cull option and under both caps. Sort ties keep expansion order on both
sides (stable sorts).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.ops import binning as jbin
from neuralgaussiansplatting_torch.ops import binning as tbin
from neuralgaussiansplatting_torch.ops import preprocess as tpp

from scenes import make_camera
from torch_parity import jax_preprocess, scene_inputs, tuple_to_torch

torch.set_num_threads(2)

_jax_bin = jax.jit(jbin.bin_gaussians, static_argnums=(1, 2, 3, 4, 5),
                   static_argnames=("pack_keys", "packed_capacity",
                                    "precise_cull", "block_x", "block_y",
                                    "width", "height", "expand", "dense_cap"))


@functools.cache
def _jax_pre(deg, tight, block):
    return jax_preprocess(*map(jnp.asarray, scene_inputs(deg=deg)),
                          sh_degree=deg, cam=make_camera(W=64, H=64),
                          block_x=block, block_y=block, tight=tight)


def _assert_bins_equal(pre_j, *args, **kw):
    want = _jax_bin(pre_j, *args, **kw)
    got = tbin.bin_gaussians(tuple_to_torch(pre_j, tpp.Preprocessed), *args,
                             **kw)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    return want


@pytest.mark.parametrize("expand", ["scatter", "dense"])
@pytest.mark.parametrize("precise_cull", [False, True])
@pytest.mark.parametrize("fast_sort", [False, True])
def test_bin_gaussians_matches_jax(fast_sort, precise_cull, expand):
    pre_j = _jax_pre(1, True, 32)
    inst = _assert_bins_equal(
        pre_j, 2, 2, 1 << 12, 1024, 128, pack_keys=fast_sort,
        precise_cull=precise_cull, block_x=32, block_y=32, width=64,
        height=64, expand=expand)
    assert int(inst.dropped) == 0 and int(inst.num_rendered) > 0
    if precise_cull:
        assert int(inst.culled) > 0


def test_bin_small_tiles_matches_jax():
    pre_j = _jax_pre(3, False, 16)
    _assert_bins_equal(pre_j, 4, 4, 1 << 12, 256, 32, pack_keys=True,
                       precise_cull=True, block_x=16, block_y=16, width=64,
                       height=64, expand="dense", dense_cap=4)


def test_bin_capacity_overflow_matches_jax():
    """Expansion truncation (capacity < demand) and whole-tile drops
    (packed_capacity < aligned demand) report the same monitors."""
    pre_j = _jax_pre(1, False, 32)
    inst = _assert_bins_equal(
        pre_j, 2, 2, 256, 1024, 128, packed_capacity=384, pack_keys=False,
        precise_cull=True, block_x=32, block_y=32, width=64, height=64)
    assert int(inst.num_rendered) > 256 and int(inst.dropped) > 0
    assert int(inst.aligned_demand) > 384


def test_bin_max_per_tile_matches_jax():
    pre_j = _jax_pre(1, True, 32)
    inst = _assert_bins_equal(
        pre_j, 2, 2, 1 << 12, 40, 128, pack_keys=True, precise_cull=False,
        block_x=32, block_y=32, width=64, height=64)
    assert int(inst.max_tile_load) > 40 and int(inst.dropped) > 0
