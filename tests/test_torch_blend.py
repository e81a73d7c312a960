"""PyTorch port vs the JAX package: the blend stage.

The plain version of K1 (``blend_tiles_seq_reference``, what the seq backend
runs on the CPU) is held against the JAX seq kernel in interpret mode on the
same ``Instances`` and attributes, with the gates of tests/test_blend_seq.py:
color and final T to atol 5e-5, n_contrib equal on >= 99.9 % of pixels. K1
itself runs only on a GPU (tests/test_torch_cuda.py); the backward (K2)
is held against JAX in tests/test_torch_blend_bwd.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.ops import blend as jblend
from neuralgaussiansplatting_tpu.ops import blend_seq as jseq
from neuralgaussiansplatting_tpu.ops import binning as jbin
from neuralgaussiansplatting_torch.ops import blend as tblend
from neuralgaussiansplatting_torch.ops import blend_pallas as tbp
from neuralgaussiansplatting_torch.ops import blend_seq as tseq
from neuralgaussiansplatting_torch.ops import rasterize as trast

from scenes import make_camera, random_gaussians
from test_torch_cuda import (
    assert_box_holds_every_live_pair, assert_cutoff_never_skips_a_blend,
    sweep_splats,
)
from torch_parity import port_camera, port_stage_inputs as _port_stage_inputs
from torch_parity import to_torch

torch.set_num_threads(2)

_jax_seq = jax.jit(jseq.blend_tiles_seq, static_argnums=(5, 6, 7, 8, 9))
_jax_scan = jax.jit(jblend.blend_tiles, static_argnums=(5, 6, 7, 8, 9, 10))


def _as_jax(inst, attrs):
    """(Instances, *attrs) as JAX arrays."""
    return (jbin.Instances(*(jnp.asarray(x.numpy()) for x in inst)),
            *(jnp.asarray(a.numpy()) for a in attrs))


def _assert_blend_close(got, want, atol=5e-5):
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               atol=atol)
    np.testing.assert_allclose(got.final_t.numpy(), np.asarray(want.final_t),
                               atol=atol)
    agree = (got.n_contrib.numpy() == np.asarray(want.n_contrib)).mean()
    assert agree >= 0.999, agree


@pytest.mark.parametrize("scene", ["default", "early_stop"])
def test_seq_plain_version_matches_jax_seq_kernel(scene):
    """K1's plain version vs the JAX seq kernel (interpret mode); the
    early-stop scene (opacity 0.995) drives pixels below T = 1e-4."""
    if scene == "default":
        inst, attrs, t = _port_stage_inputs(120, 1, 3)
    else:
        inst, attrs, t = _port_stage_inputs(250, 0, 5, opacity=0.995)
    got = trast.blend_tiles(inst, *attrs, t, t, trast.make_settings("seq"))
    want = _jax_seq(*_as_jax(inst, attrs), t, t, 32, 32, 1024)
    _assert_blend_close(got, want)
    if scene == "early_stop":
        assert (got.final_t.numpy() < 2e-4).any()


def test_scan_oracle_matches_jax_scan():
    inst, attrs, t = _port_stage_inputs(150, 1, 9, block=16, chunk=32)
    got = tblend.blend_tiles(inst, *attrs, t, t, 16, 16, 256, 32)
    want = _jax_scan(*_as_jax(inst, attrs), t, t, 16, 16, 256, 32)
    _assert_blend_close(got, want)
    np.testing.assert_array_equal(
        tblend.assemble_image(got.color, t, t, 16, 16, 60, 50).numpy(),
        np.asarray(jblend.assemble_image(jnp.asarray(got.color.numpy()),
                                         t, t, 16, 16, 60, 50)))


def test_seq_inference_mode_track_contrib_off():
    inst, attrs, t = _port_stage_inputs(80, 1, 11)
    settings = trast.make_settings("seq")
    on = trast.blend_tiles(inst, *attrs, t, t, settings)
    off = trast.blend_tiles(inst, *attrs, t, t, dataclasses.replace(
        settings, track_contrib=False))
    np.testing.assert_array_equal(off.color.numpy(), on.color.numpy())
    np.testing.assert_array_equal(off.final_t.numpy(), on.final_t.numpy())
    assert not off.n_contrib.any() and on.n_contrib.any()


def test_padding_slots_read_the_zero_sentinel():
    inst, attrs, _ = _port_stage_inputs(60, 1, 2)
    packed = tblend.pack_gather(tblend.pack_instance_attrs_t(*attrs), inst.gid)
    assert packed.shape == (tblend.PROWS, inst.gid.shape[0])
    assert not packed[:, ~inst.valid].any()
    assert (packed[:, inst.valid] != 0).any(dim=1).all()


@pytest.mark.parametrize("backend, kw", [
    ("seq", dict(block_x=16, block_y=16)),
    ("seq", dict(chunk=64)),
    ("pallas", dict()),
    ("tiled", dict()),
], ids=["seq-16x16", "seq-chunk64", "pallas", "unknown"])
def test_unported_or_mismatched_backends_raise(backend, kw):
    """Only an unknown backend raises. A seq setting of another tile or
    chunk shape takes the pallas route (K4/K5), and renders bit-equal to
    the explicit pallas setting of the same shape; backend="pallas"
    renders."""
    cam = port_camera(make_camera(W=32, H=32))
    arrays = list(map(to_torch, random_gaussians(n=20, deg=0, seed=1)))
    settings = trast.make_settings(backend, **kw)
    if backend == "tiled":
        with pytest.raises(ValueError):
            trast.rasterize(*arrays, 0, cam, torch.zeros(3), settings)
        return
    assert trast.blend_route(settings) == "pallas"
    got = trast.rasterize(*arrays, 0, cam, torch.zeros(3), settings)
    want = trast.rasterize(*arrays, 0, cam, torch.zeros(3),
                           dataclasses.replace(settings, backend="pallas"))
    assert int(got.num_rendered) > 0 and got.color.abs().sum() > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["seq", "pallas"])
def test_blend_refuses_tensors_that_need_grad(backend):
    """The kernel wrappers (K1/K2, K4/K5) refuse tensors that require grad
    (a launch would drop the gradient); ``rasterize.blend_tiles``, their
    autograd entry, takes them and gives every attribute a gradient."""
    if backend == "seq":
        inst, attrs, t = _port_stage_inputs(40, 1, 4)
        fwd, bwd, shape = tseq.blend_seq_fwd, tseq.blend_seq_bwd, ()
    else:
        inst, attrs, t = _port_stage_inputs(40, 1, 4, block=16, chunk=16)
        fwd, bwd, shape = tbp.blend_pallas_fwd, tbp.blend_pallas_bwd, (16, 16)
    packed = tblend.pack_gather(tblend.pack_instance_attrs_t(*attrs), inst.gid)
    args = (inst.tile_start, inst.tile_count)
    raw = fwd(packed, *args, t, *shape)
    with pytest.raises(ValueError):
        fwd(packed.clone().requires_grad_(), *args, t, *shape)
    with pytest.raises(ValueError):
        bwd(packed, *args, raw.clone().requires_grad_(), torch.ones_like(raw),
            t, *shape)
    leaves = [a.clone().requires_grad_() for a in attrs]
    res = trast.blend_tiles(inst, *leaves, t, t,
                            trast.make_settings(backend))
    (res.color.sum() + res.final_t.sum()).backward()
    for leaf in leaves:
        assert leaf.grad is not None and leaf.grad.abs().sum() > 0


def test_k1_wrapper_validates_inputs():
    packed = torch.zeros((9, 256))
    start = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tseq.blend_seq_fwd(packed.double(), start, start, 2)
    with pytest.raises(ValueError):
        tseq.blend_seq_fwd(packed, start.long(), start, 2)
    with pytest.raises(ValueError):
        tseq.blend_seq_fwd(packed[:8], start, start, 2)
    with pytest.raises(ValueError):
        tseq.blend_seq_fwd(packed, start, start, 3)


def test_alpha_floor_cutoff_never_skips_a_pair_that_blends():
    """The PyTorch version of the kernels' alpha-floor cutoff: over a dense
    sweep of op in (0, 1] and of the powers just below each cutoff, float32
    min(0.99, op * exp(power)) stays below ALPHA_MIN, and 1e-3 above the
    threshold every pair blends (``assert_cutoff_never_skips_a_blend``;
    tests/test_torch_cuda.py holds the kernels' own cutoff to the same
    sweep and to this one on the card)."""
    ops, cut = assert_cutoff_never_skips_a_blend(tblend.alpha_floor_cutoff)
    assert torch.equal(tblend.stage_cutoff_box(torch.cat([
        torch.zeros((5, ops.numel())), ops[None],
        torch.zeros((3, ops.numel()))]))[0], cut)


def test_instance_box_holds_every_pair_that_is_not_skipped():
    """The PyTorch version of the kernels' per-warp box: on random splats
    from round to needle-thin, every pixel just outside the box computes,
    in float32 and the kernels' operation order, a power below the cutoff
    (``assert_box_holds_every_live_pair``; the card test holds the kernels'
    own box to the same sweep)."""
    splats = sweep_splats()
    cut = tblend.alpha_floor_cutoff(splats[5])
    box = tblend.instance_box(*splats)
    assert_box_holds_every_live_pair(*splats, cut, box)
    packed = torch.cat([torch.stack(splats), torch.zeros((3, cut.numel()))])
    assert torch.equal(tblend.stage_cutoff_box(packed),
                       torch.cat([cut[None], box]))


def test_cutoff_and_box_hold_in_the_pallas_association():
    """K4 and K5 skip by K1's and K2's cutoff and box, with the power in
    their own association, -0.5*((A*dx)*dx + (C*dy)*dy) - (B*dx)*dy
    (``blend_power(..., "pallas")``). Their alpha of a given power is the
    same float32 expression, so the cutoff sweep holds as it stands; the
    splat sweep holds the box with the power rounded in that association.
    An unknown association raises."""
    assert_cutoff_never_skips_a_blend(tblend.alpha_floor_cutoff)
    splats = sweep_splats()
    cut = tblend.alpha_floor_cutoff(splats[5])
    box = tblend.instance_box(*splats)
    assert_box_holds_every_live_pair(*splats, cut, box, association="pallas")
    dx, dy = torch.tensor([3.0, -7.5]), torch.tensor([-1.25, 2.0])
    ca, cbc, cc = torch.tensor([0.3, 1e-3]), torch.tensor([0.1, -2e-4]), \
        torch.tensor([0.7, 5e-3])
    assert torch.equal(tblend.blend_power(dx, dy, ca, cbc, cc, "pallas"),
                       -0.5 * ((ca * dx) * dx + (cc * dy) * dy)
                       - (cbc * dx) * dy)
    with pytest.raises(ValueError, match="association"):
        tblend.blend_power(dx, dy, ca, cbc, cc, "xla")


def test_stage_cutoff_box_validates_its_table():
    with pytest.raises(ValueError, match="float32"):
        tblend.stage_cutoff_box(torch.zeros((8, 4)))
    with pytest.raises(ValueError, match="float32"):
        tblend.stage_cutoff_box(torch.zeros((9, 4), dtype=torch.float64))
    assert tblend.stage_cutoff_box(torch.zeros((9, 0))).shape == (5, 0)


def test_expand_auto_is_the_scatter_expansion():
    cam = port_camera(make_camera(W=32, H=32))
    arrays = list(map(to_torch, random_gaussians(n=30, deg=0, seed=3)))
    outs = [trast.rasterize(*arrays, 0, cam, torch.zeros(3),
                            trast.make_settings("seq", expand=mode))
            for mode in ("auto", "scatter")]
    assert torch.equal(outs[0].color, outs[1].color)
    assert int(outs[0].num_rendered) == int(outs[1].num_rendered) > 0
