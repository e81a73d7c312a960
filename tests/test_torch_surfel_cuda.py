"""The surfel kernels on the card: the preprocess kernels' surfel variant
(``csrc/preprocess_{fwd,bwd}.cu``) and the surfel blend pair
(``csrc/surfel_blend_{fwd,bwd}.cu``), each against its plain version run on
the card, at the cell's size (5,000,000 surfels in garden840's cube,
1297 x 840), and the launch counters of a ``Trainer`` step over surfels.

This file imports no JAX, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_surfel_cuda.py

Tolerances. The kernels repeat their plain versions' operation order, but
the preprocess's matrix products (cuBLAS in the plain version, the
kernels' fused sums for the centre's column) and the reductions of
autograd and of the blend backward's per-surfel sums (a warp tree and the
16 warps in order, against ``sum`` over the pixels) run in orders of their
own. So: the depths equal (binning sorts by their bits); the float fields
and the blend's 14 channels within 1e-5 of each field's largest value
(the channels' n_contrib and median index equal but at 1e-5 of the
pixels); integer fields equal but at 1e-5 of the rows (a value within
rounding of an integer before floor or ceil); gradients within the
repository's gradient gate, atol 5e-4 max|g| and rtol 5e-3, and 1e-4 of
the norm.
"""

import math

import pytest
import torch

from neuralgaussiansplatting_torch.ops import binning, blend
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops import surfel_blend as sb
from neuralgaussiansplatting_torch.train import loop

import surfel_cases as sc

N = 5_000_000
W, H = 1297, 840
# garden840's cube and the cell's camera distance
SIDE = 2.4
POS = (0.0, -1.0, -4.0)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on an NVIDIA GPU")


@pytest.fixture(scope="module")
def case():
    _need_gpu()
    dev = torch.device("cuda")
    leaves = sc.cloud(N, 12, dev, side=SIDE,
                      log_scale=math.log(SIDE / N ** (1 / 3)) - 2.2)
    cam = sc.port_camera(sc.camera(W, H, pos=POS), dev)
    return leaves, cam


def _inputs(leaves):
    sh = torch.cat([leaves["features_dc"], leaves["features_rest"]], 1)
    return (leaves["xyz"], torch.exp(leaves["scaling"]), leaves["rotation"],
            torch.sigmoid(leaves["opacity"][:, 0]), sh)


def _close(got, want, name, scale=None):
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max()) if scale is None else scale
    err = float((got - want).abs().max())
    assert err <= 1e-5 * max(scale, 1e-30), f"{name}: {err} of {scale}"


def _gate(got, want, name):
    big = float(want.abs().max())
    assert torch.allclose(got, want, atol=5e-4 * big, rtol=5e-3), name
    assert float((got - want).norm()) <= 1e-4 * float(want.norm()), name


def _mostly_equal(got, want, name, rows):
    differ = int((got != want).reshape(got.shape[0], -1).any(1).sum())
    assert differ <= 1e-5 * rows, f"{name}: {differ} rows differ"


@pytest.mark.cuda
def test_surfel_preprocess_matches_its_plain_version(case):
    leaves, cam = case
    xyz, scale, rot, op, sh = _inputs(leaves)
    outs, grads = [], []
    for fn in (pp.preprocess_surfels, pp.preprocess_surfels_reference):
        ins = [t.detach().clone().requires_grad_()
               for t in (xyz, scale, rot, sh)]
        off = torch.zeros((N, 2), device=xyz.device, requires_grad=True)
        before = (pp.launches, pp.bwd_launches)
        o = fn(ins[0], ins[1], ins[2], op, ins[3], 3, cam, 32, 32,
               means2d_offset=off)
        g = torch.Generator(device=xyz.device).manual_seed(3)
        total = sum((getattr(o, f) * torch.randn(getattr(o, f).shape,
                                                 generator=g,
                                                 device=xyz.device)).sum()
                    for f in ("means2d", "transmat", "normal", "rgb"))
        grads.append(torch.autograd.grad(total, ins + [off]))
        outs.append(o)
        if fn is pp.preprocess_surfels:
            assert (pp.launches, pp.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    k, r = outs
    assert torch.equal(k.depths, r.depths)
    for f in ("means2d", "transmat", "normal", "rgb"):
        _close(getattr(k, f), getattr(r, f), f)
    for f in ("radii", "rect_min", "rect_max", "tiles_touched"):
        _mostly_equal(getattr(k, f), getattr(r, f), f, N)
    for name, a, b in zip(("xyz", "scale", "rotation", "sh", "offset"),
                          *grads):
        _gate(a, b, name)


@pytest.fixture(scope="module")
def blended(case):
    leaves, cam = case
    xyz, scale, rot, op, sh = _inputs(leaves)
    tiles_x = (W + 31) // 32
    with torch.no_grad():
        pre = pp.preprocess_surfels(xyz, scale, rot, op, sh, 3, cam, 32, 32)
        inst = binning.bin_gaussians(
            pre, tiles_x, (H + 31) // 32, 1 << 25, 1 << 20, 128,
            precise_cull=False, block_x=32, block_y=32, width=W, height=H)
        packed = blend.pack_gather(blend.pack_instance_attrs_t(
            pre.means2d, pre.transmat, pre.opacity, pre.rgb, pre.normal),
            inst.gid)
    assert int(inst.dropped) == 0
    return packed, inst, tiles_x


@pytest.mark.cuda
def test_surfel_blend_forward_matches_its_plain_version(blended):
    packed, inst, tiles_x = blended
    before = sb.launches
    raw = sb.surfel_blend_fwd(packed, inst.tile_start, inst.tile_count,
                              tiles_x)
    assert sb.launches == before + 1
    plain = sb.surfel_blend_fwd_reference(packed, inst.tile_start,
                                          inst.tile_count, tiles_x)
    for c in range(sb.CHANNELS):
        if c in (4, 13):        # n_contrib, the median's index
            _mostly_equal(raw[:, c].reshape(-1, 1), plain[:, c].reshape(-1, 1),
                          f"channel {c}", raw[:, c].numel())
        else:
            _close(raw[:, c], plain[:, c], f"channel {c}")


@pytest.mark.cuda
def test_surfel_blend_backward_matches_its_plain_version(blended):
    packed, inst, tiles_x = blended
    raw = sb.surfel_blend_fwd(packed, inst.tile_start, inst.tile_count,
                              tiles_x)
    g = torch.Generator(device=raw.device).manual_seed(5)
    cot = torch.randn(raw.shape, generator=g, device=raw.device)
    before = sb.bwd_launches
    got = sb.surfel_blend_bwd(packed, inst.tile_start, inst.tile_count, raw,
                              cot, tiles_x)
    assert sb.bwd_launches == before + 1
    again = sb.surfel_blend_bwd(packed, inst.tile_start, inst.tile_count,
                                raw, cot, tiles_x)
    assert torch.equal(got, again)
    plain = sb.surfel_blend_bwd_reference(packed, inst.tile_start,
                                          inst.tile_count, raw, cot, tiles_x)
    for row in range(sb.SROWS):
        _gate(got[row], plain[row], f"row {row}")


@pytest.mark.cuda
def test_a_surfel_step_launches_each_kernel_once():
    """One ``Trainer.step`` over surfels: one preprocess launch each way,
    one surfel blend launch each way and one binning call, and no K1/K2;
    nothing in it is read back to the host."""
    _need_gpu()
    from neuralgaussiansplatting_torch.ops import blend_seq
    dev = torch.device("cuda")
    leaves = sc.cloud(20_000, 13, dev)
    cam = sc.port_camera(sc.camera(320, 240), dev)
    tr = loop.Trainer(gaussians=sc.model(leaves), settings=rast.make_settings(
        "seq", capacity=1 << 20, max_per_tile=1 << 14, precise_cull=False),
        lambda_dist=100.0)
    gt = torch.rand((3, 240, 320), device=dev)
    tr.step(cam, gt, 15001)
    counters = (pp, "launches"), (pp, "bwd_launches"), (sb, "launches"), \
        (sb, "bwd_launches"), (binning, "launches"), (blend_seq, "launches")
    before = [getattr(m, a) for m, a in counters]
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = tr.step(cam, gt, 15002)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    after = [getattr(m_, a) for m_, a in counters]
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1, 1, 1, 0]
    assert math.isfinite(float(m["loss"]))
