"""PyTorch port vs the JAX package: the 16x16 lane-layout blend kernels.

The plain versions of K4 and K5 (``blend_tiles_pallas_reference`` and
``blend_tiles_pallas_bwd_reference``, what ``blend_pallas_fwd`` /
``blend_pallas_bwd`` run on the CPU) are held against the JAX package's
``blend_pallas._fwd_call`` / ``_bwd_call`` in interpret mode, on the same
packed table (its 9 rows padded to the TPU's 16), tile ranges, forward
output and cotangent. Gates: color and final T to atol 1e-5, n_contrib
equal on >= 99.9 % of pixels; gradients to 5e-5 of each row's max |g|. The
two differ only in rounding: the TPU kernel forms T and the backward prefix
with lane scans and sums its lanes at the end, the port carries them
sequentially. K4 and K5 themselves run only on a GPU
(tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.ops import blend_pallas as jbp
from neuralgaussiansplatting_torch.ops import blend as tblend
from neuralgaussiansplatting_torch.ops import blend_pallas as tbp
from neuralgaussiansplatting_torch.ops import blend_seq as tseq

from torch_parity import port_stage_inputs

torch.set_num_threads(2)

_STATIC = ("num_tiles", "ch", "block_x", "block_y", "tiles_x",
           "track_contrib")


def _pad16(packed9):
    return jnp.concatenate(
        [packed9,
         jnp.zeros((16 - tblend.PROWS, packed9.shape[1]), jnp.float32)])


def _pad8(per_tile):
    """(T, 5, PIX) -> the TPU kernels' (T, 8, PIX)."""
    return jnp.concatenate(
        [per_tile, jnp.zeros((per_tile.shape[0], 3, per_tile.shape[2]),
                             jnp.float32)], axis=1)


@functools.partial(jax.jit, static_argnames=_STATIC)
def _jax_fwd(packed9, tile_start, tile_count, *, num_tiles, ch, block_x,
             block_y, tiles_x, track_contrib):
    raw = jbp._fwd_call(
        _pad16(packed9), tile_start, tile_count, num_tiles=num_tiles, ch=ch,
        pix=block_x * block_y, block_x=block_x, block_y=block_y,
        tiles_x=tiles_x, interpret=True, track_contrib=track_contrib)
    return raw[:, :5]


@functools.partial(jax.jit, static_argnames=_STATIC)
def _jax_bwd(packed9, raw, cot, tile_start, tile_count, *, num_tiles, ch,
             block_x, block_y, tiles_x, track_contrib):
    grad = jbp._bwd_call(
        _pad16(packed9), _pad8(raw), _pad8(cot), tile_start, tile_count,
        num_tiles=num_tiles, ch=ch, pix=block_x * block_y, block_x=block_x,
        block_y=block_y, tiles_x=tiles_x, interpret=True,
        track_contrib=track_contrib)
    return grad[:tblend.PROWS]


def _inputs(scene, block, chunk):
    if scene == "early_stop":
        inst, attrs, t = port_stage_inputs(250, 0, 5, opacity=0.995,
                                           block=block, chunk=chunk)
    else:
        inst, attrs, t = port_stage_inputs(150, 1, 3, block=block,
                                           chunk=chunk)
    packed = tblend.pack_gather(tblend.pack_instance_attrs_t(*attrs), inst.gid)
    return inst, packed, t


def _as_jax(*tensors):
    return tuple(jnp.asarray(x.numpy()) for x in tensors)


@pytest.mark.parametrize("block, chunk, scene, track_contrib", [
    (16, 8, "default", True),
    (16, 128, "default", True),
    (32, 64, "default", True),
    (8, 16, "default", True),
    (16, 8, "early_stop", True),
    (16, 8, "default", False),
])
def test_k4_plain_version_matches_jax_fwd_kernel(block, chunk, scene,
                                                 track_contrib):
    """The early-stop scene (opacity 0.995) drives pixels below T = 1e-4;
    without ``track_contrib`` both write zeros for n_contrib."""
    inst, packed, t = _inputs(scene, block, chunk)
    args = (inst.tile_start, inst.tile_count)
    got = tbp.blend_pallas_fwd(packed, *args, t, block, block,
                               track_contrib).numpy()
    want = np.asarray(_jax_fwd(
        *_as_jax(packed, *args), num_tiles=t * t, ch=chunk, block_x=block,
        block_y=block, tiles_x=t, track_contrib=track_contrib))
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-5)
    assert (got[:, 4] == want[:, 4]).mean() >= 0.999
    assert got[:, 4].any() == track_contrib
    if scene == "early_stop":
        assert (got[:, 3] < 2e-4).any()


@pytest.mark.parametrize("block, chunk, scene, track_contrib", [
    (16, 8, "default", True),
    (16, 8, "default", False),
    (16, 8, "early_stop", True),
    (32, 64, "default", True),
])
def test_k5_plain_version_matches_jax_bwd_kernel(block, chunk, scene,
                                                 track_contrib):
    inst, packed, t = _inputs(scene, block, chunk)
    args = (inst.tile_start, inst.tile_count)
    raw = tbp.blend_pallas_fwd(packed, *args, t, block, block, track_contrib)
    cot = torch.from_numpy(np.random.default_rng(1).normal(
        size=raw.shape).astype(np.float32))
    got = tbp.blend_pallas_bwd(packed, *args, raw, cot, t, block, block,
                               track_contrib).numpy()
    want = np.asarray(_jax_bwd(
        *_as_jax(packed, raw, cot, *args), num_tiles=t * t, ch=chunk,
        block_x=block, block_y=block, tiles_x=t,
        track_contrib=track_contrib))
    valid = inst.valid.numpy()
    for row in range(tblend.PROWS):
        scale = np.abs(want[row, valid]).max()
        np.testing.assert_allclose(got[row, valid], want[row, valid],
                                   atol=5e-5 * scale, rtol=0,
                                   err_msg=f"row {row}")
    assert not got[:, ~valid].any()
    assert (got[:, valid] != 0).any(axis=1).all()


def test_k5_stops_at_the_deepest_contributor():
    """With n_contrib tracked, K5 skips the slots past each tile's deepest
    contributor; those slots' gradients are exactly zero either way."""
    inst, attrs, t = port_stage_inputs(300, 0, 5, opacity=0.995, block=16,
                                       chunk=8, scale_lo=0.1, scale_hi=0.3)
    packed = tblend.pack_gather(tblend.pack_instance_attrs_t(*attrs), inst.gid)
    args = (inst.tile_start, inst.tile_count)
    raw = tbp.blend_pallas_fwd(packed, *args, t, 16, 16)
    cot = torch.ones_like(raw)
    on = tbp.blend_pallas_bwd(packed, *args, raw, cot, t, 16, 16, True)
    off = tbp.blend_pallas_bwd(packed, *args, raw, cot, t, 16, 16, False)
    np.testing.assert_array_equal(on.numpy(), off.numpy())
    assert (raw[:, 4].amax(dim=1) < inst.tile_count.float()).any()
    _, walked_on, blended = tbp.blend_tiles_pallas_bwd_reference(
        packed, *args, raw, cot, t, 16, 16, True, return_pairs=True)
    _, walked_off, blended_off = tbp.blend_tiles_pallas_bwd_reference(
        packed, *args, raw, cot, t, 16, 16, False, return_pairs=True)
    assert 0 < blended == blended_off <= walked_on < walked_off
    # K4 visits what K5 walks without the stop, and blends the same pairs
    _, visited, blended_fwd = tbp.blend_tiles_pallas_reference(
        packed, *args, t, 16, 16, return_pairs=True)
    assert (visited, blended_fwd) == (walked_off, blended)


@pytest.mark.parametrize("block, chunk", [(16, 8), (32, 128), (8, 16)])
def test_pair_counter_agrees_with_the_plain_versions(block, chunk):
    """``blend.blend_pair_counts``, the one counter behind the bounds of
    K1, K2, K4 and K5: its visited and blended pairs are the plain K4's
    ``return_pairs`` counts (and the plain K5's blended pairs) at 16x16,
    32x32 and 8x8, and at 32x32 in K1's association the plain K1's. Each
    pixel walks (backward) exactly its n_contrib pairs; the pairs that need
    alpha lie inside the box, and the blended pairs among them; the box
    pairs lie in the counted (instance, column) and (instance, row) pairs."""
    inst, packed, t = _inputs("default", block, chunk)
    args = (packed, inst.tile_start, inst.tile_count, t)
    raw, visited, blended = tbp.blend_tiles_pallas_reference(
        *args, block, block, return_pairs=True)
    cot = torch.ones_like(raw)
    _, walked_flat, blended_bwd = tbp.blend_tiles_pallas_bwd_reference(
        *args[:3], raw, cot, t, block, block, return_pairs=True)
    n = tblend.blend_pair_counts(*args, block, block, raw, "pallas")
    assert (n["visited"], n["blended"]) == (visited, blended)
    assert blended_bwd == blended > 0
    assert n["walked"] == int(raw[:, 4].sum()) <= walked_flat
    for d in ("fwd", "bwd"):
        assert n["blended"] <= n[f"{d}_live"] <= n[f"{d}_box"]
        assert 0 < n[f"{d}_staged"] <= int(inst.tile_count.sum())
        for lines in ("cols", "rows"):  # block pixels to a column or row
            assert 0 < n[f"{d}_{lines}"] <= n[f"{d}_box"]
            assert n[f"{d}_box"] <= n[f"{d}_{lines}"] * block
    assert n["fwd_box"] <= n["visited"] and n["bwd_box"] <= n["walked"]
    if block == 32:
        raw1, visited1, blended1 = tseq.blend_tiles_seq_reference(
            *args, return_pairs=True)
        n1 = tblend.blend_pair_counts(*args, 32, 32, raw1, "seq")
        assert (n1["visited"], n1["blended"]) == (visited1, blended1)


def test_k4_k5_wrappers_validate_inputs():
    packed = torch.zeros((9, 256))
    start = torch.zeros(4, dtype=torch.int32)
    raw = torch.zeros((4, 5, 256))
    with pytest.raises(ValueError):
        tbp.blend_pallas_fwd(packed.double(), start, start, 2, 16, 16)
    with pytest.raises(ValueError):
        tbp.blend_pallas_fwd(packed, start.long(), start, 2, 16, 16)
    with pytest.raises(ValueError):
        tbp.blend_pallas_fwd(packed[:8], start, start, 2, 16, 16)
    with pytest.raises(ValueError):
        tbp.blend_pallas_fwd(packed, start, start, 3, 16, 16)
    with pytest.raises(ValueError):   # more pixels than a block holds
        tbp.blend_pallas_fwd(packed, start, start, 2, 64, 64)
    with pytest.raises(ValueError):   # raw of another tile shape
        tbp.blend_pallas_bwd(packed, start, start, raw, raw, 2, 32, 32)
    with pytest.raises(ValueError):
        tbp.blend_pallas_bwd(packed, start, start, raw, raw.double(), 2, 16,
                             16)
    out = tbp.blend_pallas_fwd(packed, start, start, 2, 16, 16)
    assert out.shape == (4, 5, 256)
    assert torch.equal(out[:, 3], torch.ones((4, 256)))
    assert not out[:, [0, 1, 2, 4]].any()
    grad = tbp.blend_pallas_bwd(packed, start, start, out, out, 2, 16, 16)
    assert grad.shape == (9, 256) and not grad.any()
