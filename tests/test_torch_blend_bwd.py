"""PyTorch port vs the JAX package: the seq blend's backward.

K2's plain version (``blend_tiles_seq_bwd_reference``, what ``blend_seq_bwd``
runs on the CPU) is held against the JAX seq backward kernel in interpret
mode plus its XLA epilogue, on the same packed table, forward output and
cotangent. The gate is the one of tests/test_blend_seq.py:97-102: atol
5e-4 * max|g| and rtol 5e-3 per row (the JAX kernel sums tile-centred
moments and recombines them; the port sums the rows directly). The
per-Gaussian reduction of the gradient (``pack_gather``'s backward) is held
against an exact float64 sum. K2 itself runs only on a GPU
(tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.ops import blend_seq as jseq
from neuralgaussiansplatting_torch.ops import blend as tblend
from neuralgaussiansplatting_torch.ops import blend_seq as tseq

from torch_parity import port_stage_inputs

torch.set_num_threads(2)


@functools.partial(jax.jit, static_argnames=("tiles_x", "track_contrib"))
def _jax_bwd_rows(packed9, raw, cot, tile_start, tile_count, *, tiles_x,
                  track_contrib):
    """JAX ``_bwd_call`` + ``_epilogue`` on the port's layouts: the 9-row
    table padded to 16 rows, raw/cot as (T, 5, 8, 128)."""
    p16 = jnp.concatenate(
        [packed9, jnp.zeros((7, packed9.shape[1]), jnp.float32)])
    num_tiles = tile_start.shape[0]
    gb = jseq._bwd_call(
        p16, raw.reshape(num_tiles, 5, 8, 128),
        cot.reshape(num_tiles, 5, 8, 128), tile_start, tile_count,
        num_tiles=num_tiles, ch=128, tiles_x=tiles_x, interpret=True,
        track_contrib=track_contrib)
    return jseq._epilogue(gb, p16)


def _bwd_inputs(scene):
    if scene == "early_stop":
        inst, attrs, t = port_stage_inputs(250, 0, 5, opacity=0.995)
    else:
        inst, attrs, t = port_stage_inputs(120, 1, 3)
    packed = tblend.pack_gather(tblend.pack_instance_attrs_t(*attrs), inst.gid)
    return inst, packed, t


def _assert_rows_close(got, want, valid):
    """The JAX seq gradient gate, row by row over the valid slots."""
    got, want = got[:, valid], want[:, valid]
    for row in range(9):
        scale = np.abs(want[row]).max() + 1e-8
        np.testing.assert_allclose(got[row], want[row], atol=5e-4 * scale,
                                   rtol=5e-3, err_msg=f"row {row}")


@pytest.mark.parametrize("scene, track_contrib", [
    ("default", True), ("default", False), ("early_stop", True)])
def test_k2_plain_version_matches_jax_bwd_kernel(scene, track_contrib):
    inst, packed, t = _bwd_inputs(scene)
    args = (inst.tile_start, inst.tile_count)
    raw = tseq.blend_seq_fwd(packed, *args, t, track_contrib)
    cot = torch.from_numpy(np.random.default_rng(1).normal(
        size=raw.shape).astype(np.float32))
    got = tseq.blend_seq_bwd(packed, *args, raw, cot, t, track_contrib)
    want = _jax_bwd_rows(*(jnp.asarray(x.numpy())
                           for x in (packed, raw, cot, *args)),
                         tiles_x=t, track_contrib=track_contrib)
    valid = inst.valid.numpy()
    _assert_rows_close(got.numpy(), np.asarray(want), valid)
    assert not got[:, ~inst.valid].any()
    assert (got[:, inst.valid] != 0).any(dim=1).all()
    if scene == "early_stop":
        assert (raw[:, 3] < 2e-4).any()


def test_k2_stops_at_the_deepest_contributor():
    """With n_contrib tracked, K2 skips the slots past each tile's deepest
    contributor; those slots' gradients are exactly zero either way."""
    inst, attrs, t = port_stage_inputs(300, 0, 5, opacity=0.995,
                                       scale_lo=0.1, scale_hi=0.3)
    packed = tblend.pack_gather(tblend.pack_instance_attrs_t(*attrs), inst.gid)
    args = (inst.tile_start, inst.tile_count)
    raw = tseq.blend_seq_fwd(packed, *args, t)
    cot = torch.ones_like(raw)
    on = tseq.blend_seq_bwd(packed, *args, raw, cot, t, True)
    off = tseq.blend_seq_bwd(packed, *args, raw, cot, t, False)
    np.testing.assert_array_equal(on.numpy(), off.numpy())
    deepest = raw[:, 4].amax(dim=1)
    assert (deepest < inst.tile_count.float()).any()
    _, walked_on, blended = tseq.blend_tiles_seq_bwd_reference(
        packed, *args, raw, cot, t, True, return_pairs=True)
    _, walked_off, blended_off = tseq.blend_tiles_seq_bwd_reference(
        packed, *args, raw, cot, t, False, return_pairs=True)
    assert 0 < blended == blended_off <= walked_on <= walked_off
    # K1 visits what K2 walks without the stop, and blends the same pairs
    _, visited, blended_fwd = tseq.blend_tiles_seq_reference(
        packed, *args, t, return_pairs=True)
    assert (visited, blended_fwd) == (walked_off, blended)


def test_k2_wrapper_validates_inputs():
    packed = torch.zeros((9, 256))
    start = torch.zeros(4, dtype=torch.int32)
    raw = torch.zeros((4, 5, 1024))
    with pytest.raises(ValueError):
        tseq.blend_seq_bwd(packed, start, start, raw[:, :4], raw, 2)
    with pytest.raises(ValueError):
        tseq.blend_seq_bwd(packed, start, start, raw, raw.double(), 2)
    with pytest.raises(ValueError):
        tseq.blend_seq_bwd(packed, start, start, raw[:3], raw[:3], 2)
    out = tseq.blend_seq_bwd(packed, start, start, raw, raw, 2)
    assert out.shape == (9, 256) and not out.any()


def _exact_reduction(cot9, gid, n):
    want = np.zeros((9, n + 1))
    np.add.at(want.T, gid, cot9.T.astype(np.float64))
    want[:, n] = 0.0
    return want


@pytest.mark.parametrize("drop", [False, True])
def test_pack_gather_gradient_is_the_exact_per_gaussian_sum(drop):
    """Backward of the gather: each Gaussian's slot rows summed (padding
    slots, gid == N, left out), with and without instances missing from
    the packed buffer, as after a cap drop."""
    rng = np.random.default_rng(4)
    n, k = 50, 700
    gid = rng.integers(0, n + 1, k)
    gid[rng.random(k) < 0.2] = n                      # padding slots
    if drop:
        gid[np.isin(gid, [3, 17, 18])] = n            # instances lost
    packed_all = torch.from_numpy(
        rng.normal(size=(9, n + 1)).astype(np.float32)).requires_grad_()
    cot9 = rng.normal(size=(9, k)).astype(np.float32)
    out = tblend.pack_gather(packed_all, torch.from_numpy(gid).int())
    np.testing.assert_array_equal(out.detach().numpy(),
                                  packed_all.detach().numpy()[:, gid])
    out.backward(torch.from_numpy(cot9))
    want = _exact_reduction(cot9, gid, n)
    np.testing.assert_allclose(packed_all.grad.numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert not packed_all.grad[:, n].any()
    again = tblend.reduce_by_gaussian(torch.from_numpy(cot9),
                                      torch.from_numpy(gid).int(), n)
    np.testing.assert_array_equal(again.numpy(), packed_all.grad.numpy())

