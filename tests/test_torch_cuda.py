"""The port's CUDA kernels on the card, against their plain versions.

This file imports no JAX, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The ``cuda`` tests skip where no CUDA device is present (a CUDA kernel has
no CPU mode); the rest check the build recipe on any host.
"""

import copy
import math
import os

import numpy as np
import pytest
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch import gaussian_renderer as gr
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.models import nets
from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import blend
from neuralgaussiansplatting_torch.ops.blend import ALPHA_MAX, ALPHA_MIN
from neuralgaussiansplatting_torch.ops import blend_pallas
from neuralgaussiansplatting_torch.ops import blend_seq
from neuralgaussiansplatting_torch.ops import decode_runs as k6
from neuralgaussiansplatting_torch.ops import idxmap as idxmap_ops
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops import zbuffer_pallas
from neuralgaussiansplatting_torch.tools import exp_decode_proto as decode_tool
from neuralgaussiansplatting_torch.tools import exp_mosaic_probe as probes
from neuralgaussiansplatting_torch.train import loop
from neuralgaussiansplatting_torch.train import optim

import k3_cases

torch.set_num_threads(2)

SETTINGS = rast.make_settings("seq", capacity=1 << 18, max_per_tile=4096,
                              fast_sort=True, tight_culling=True,
                              precise_cull=True)
PALLAS = rast.make_settings("pallas", capacity=1 << 18, max_per_tile=4096,
                            fast_sort=True, tight_culling=True,
                            precise_cull=True)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on an NVIDIA GPU")


def test_build_targets_hopper_and_keys_on_source():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--fmad=false" in _build.NVCC_FLAGS
    libs = set()
    names = ("blend_seq_fwd", "blend_seq_bwd", "blend_stage",
             "zbuffer_fwd", "blend_pallas_fwd", "blend_pallas_bwd",
             "decode_runs", "mosaic_probe", "preprocess_fwd",
             "preprocess_bwd", "adam_update", "denoise_fwd", "denoise_bwd")
    for name in names:
        src, lib = _build._target(name)
        assert os.path.exists(src)
        assert os.path.dirname(lib) == _build.BUILD_DIR
        assert lib == _build._target(name)[1]
        libs.add(lib)
    assert len(libs) == len(names)


def sweep_opacities(device="cpu"):
    """A dense sweep of opacities in (0, 1]: 100,001 evenly spaced, 2001
    log-spaced down to 1e-30, the edges (1/255, 2/255, 0.1, 0.99, 1), and
    the float32 value just below each."""
    ops = torch.cat([
        torch.linspace(1e-6, 1.0, 100_001, dtype=torch.float32),
        torch.logspace(-30, 0, 2001, dtype=torch.float32),
        torch.tensor([ALPHA_MIN, 2 * ALPHA_MIN, 0.1, 0.99, 1.0],
                     dtype=torch.float32),
    ])
    ops = torch.cat([ops, torch.nextafter(ops, torch.zeros(()))])
    return ops[ops > 0].to(device)


def assert_cutoff_never_skips_a_blend(cutoff, device="cpu"):
    """``cutoff(op)`` is the kernels' alpha-floor cutoff (their pairs with
    power < cutoff skip the expf): over ``sweep_opacities`` and the powers
    just below each cutoff (the 64 float32 values under it, and a band of
    2x the margin), float32 min(0.99, op * exp(power)), computed on
    ``device``, stays below ALPHA_MIN: a skipped pair never blends. Above
    the true threshold ln(ALPHA_MIN / op) by 1e-3 (1 + |ln|), every pair
    blends: the margin costs little. op <= 0 or NaN skips nothing. Returns
    (ops, cutoffs)."""
    ops = sweep_opacities(device)
    cut = cutoff(ops)
    assert cut.dtype == torch.float32 and torch.isfinite(cut).all()
    below = [cut]
    for _ in range(64):
        below.append(torch.nextafter(below[-1],
                                     torch.tensor(-math.inf, device=device)))
    ln = torch.log(ALPHA_MIN / ops)
    margin = (1.0 + ln.abs()) * 2.0 ** -13
    band = cut[None] - margin[None] * torch.linspace(
        0, 2, 33, dtype=torch.float32, device=device)[:, None]
    power = torch.cat([torch.stack(below[1:]), band[1:]])
    assert (power < cut).all()
    alpha = torch.clamp_max(ops * torch.exp(power), ALPHA_MAX)
    assert (alpha < ALPHA_MIN).all()
    above = ln + 1e-3 * (1.0 + ln.abs())
    alpha = torch.clamp_max(ops * torch.exp(above), ALPHA_MAX)
    assert (above > cut).all() and (alpha >= ALPHA_MIN).all()
    # the comparison with NaN is False
    odd = cutoff(torch.tensor([0.0, -0.5, math.nan], device=device))
    assert not (torch.tensor([-1e30, -1.0, 0.0], device=device) < odd).any()
    return ops, cut


def sweep_splats(n=6000, seed=5):
    """(mx, my, A, B, C, op) float32 of ``n`` random splats, from round to
    needle-thin (B^2 up to and past 0.998 AC), scales 0.3-300 px,
    opacities 1e-4-1."""
    gen = np.random.default_rng(seed)
    s1, s2 = np.exp(gen.uniform(np.log(0.3), np.log(300.0), (2, n)))
    theta = gen.uniform(0, np.pi, n)
    c, s = np.cos(theta), np.sin(theta)
    cov = np.stack([[c * c * s1 ** 2 + s * s * s2 ** 2,
                     c * s * (s1 ** 2 - s2 ** 2)],
                    [c * s * (s1 ** 2 - s2 ** 2),
                     s * s * s1 ** 2 + c * c * s2 ** 2]])
    det = cov[0, 0] * cov[1, 1] - cov[0, 1] ** 2
    mx, my = gen.uniform(-50, 2000, (2, n))
    op = np.exp(gen.uniform(np.log(1e-4), 0, n))
    return [torch.tensor(v, dtype=torch.float32)
            for v in (mx, my, cov[1, 1] / det, -cov[0, 1] / det,
                      cov[0, 0] / det, op)]


def assert_box_holds_every_live_pair(mx, my, ca, cbc, cc, op, cut, box,
                                     association="seq"):
    """A warp whose patch misses an instance's box skips the instance;
    that is exact only if every pixel outside the box computes (in
    float32, in the kernels' operation order: ``association`` "seq" for K1
    and K2, "pallas" for K4 and K5, as ``blend.blend_power`` rounds it,
    on the tensors' device) a power below the cutoff. On the integer pixels
    just outside each edge of ``box`` (4, N), over every row (column) the
    ellipse spans, the power lies below ``cut``. The box is finite for most
    splats, and empty only where op < 1/255, so that no pair blends; most
    pairs at the mean are live."""
    finite = torch.isfinite(box).all(dim=0)
    empty = box[0] > box[1]
    assert (finite | empty).float().mean() > 0.8
    assert torch.equal(empty, cut >= 0) and (op[empty] < ALPHA_MIN).all()

    i = torch.nonzero(finite).squeeze(1)
    span = torch.linspace(-1.0, 1.0, 97, device=op.device)
    for axis in range(2):
        lo, hi = box[2 * axis, i], box[2 * axis + 1, i]
        o_lo, o_hi = box[2 - 2 * axis, i], box[3 - 2 * axis, i]
        edges = torch.stack([torch.floor(lo) - 1, torch.floor(lo),
                             torch.ceil(hi), torch.ceil(hi) + 1], dim=1)
        outside = (edges < lo[:, None]) | (edges > hi[:, None])
        mid, half = (o_lo + o_hi) / 2, (o_hi - o_lo) / 2
        other = torch.round(mid[:, None] + half[:, None] * span)
        p_axis = edges[:, :, None].expand(-1, -1, span.numel())
        p_other = other[:, None, :].expand(-1, edges.shape[1], -1)
        px, py = (p_axis, p_other) if axis == 0 else (p_other, p_axis)
        power = blend.blend_power(
            mx[i, None, None] - px, my[i, None, None] - py,
            ca[i, None, None], cbc[i, None, None], cc[i, None, None],
            association)
        below = power < cut[i, None, None]
        assert below[outside].all(), axis
    power = blend.blend_power(mx[i] - torch.round(mx[i]),
                              my[i] - torch.round(my[i]), ca[i], cbc[i],
                              cc[i], association)
    assert (power >= cut[i]).float().mean() > 0.5


def _stage_on_gpu(mx, my, ca, cbc, cc, op):
    """The kernels' own cutoff and box of these instances, on the card."""
    rest = torch.zeros((3, op.numel()))
    packed = torch.stack([mx, my, ca, cbc, cc, op, *rest]).cuda()
    return blend.stage_cutoff_box(packed)


@pytest.mark.cuda
def test_stage_cutoff_box_is_exact_on_gpu():
    """The cutoff and box that K1, K2, K4 and K5 stage (``alpha_cutoff``/
    ``instance_box`` and ``stage_batch`` of csrc/blend_common.cuh, through
    csrc/blend_stage.cu): the opacity sweep never skips a pair whose
    float32 alpha on the card reaches 1/255, the splat sweep's boxes hold
    every live pair with the power rounded on the card in K1/K2's and in
    K4/K5's association, and both agree with their PyTorch versions in
    ops/blend.py (the CPU tests' subject) to far below the margins:
    2^-18 (1 + |ln|) of the cutoff, 1/64 px plus 2^-18 of a box edge."""
    _need_gpu()
    zeros = lambda n: torch.zeros(n)

    def cutoff(ops):
        n = ops.numel()
        return _stage_on_gpu(zeros(n), zeros(n), zeros(n), zeros(n),
                             zeros(n), ops.cpu())[0]

    ops, cut = assert_cutoff_never_skips_a_blend(cutoff, device="cuda")
    want = blend.alpha_floor_cutoff(ops.cpu())
    tol = 2.0 ** -18 * (1.0 + want.abs())
    assert ((cut.cpu() - want).abs() <= tol).all()

    splats = sweep_splats()
    staged = _stage_on_gpu(*splats)
    cut, box = staged[0], staged[1:]
    for association in blend.ASSOCIATIONS:
        assert_box_holds_every_live_pair(*(v.cuda() for v in splats), cut,
                                         box, association)
    want = blend.instance_box(*splats)
    box = box.cpu()
    assert torch.equal(torch.isinf(box), torch.isinf(want))
    fin = torch.isfinite(want)
    assert ((box[fin] - want[fin]).abs()
            <= 1 / 64 + 2.0 ** -18 * want[fin].abs()).all()


def _bench_like_inputs(n, w, h, device="cuda", block=32, chunk=128,
                       block_y=None):
    """Preprocess -> bin -> pack of the demo cloud, as ``rasterize`` runs
    them: K1's and K2's inputs at 32x32 tiles with chunk 128, K4's and
    K5's at any ``block`` x ``block_y`` (default square) and ``chunk``."""
    block_y = block_y or block
    params, state, cam = demo.demo_scene(n=n, w=w, h=h, sh_degree=3,
                                         device=device)
    tiles_x, tiles_y = (w + block - 1) // block, (h + block_y - 1) // block_y
    pre = pp.preprocess_gaussians(
        params.xyz, gm.get_scaling(params), gm.get_rotation(params),
        gm.get_opacity(params, state.alive), gm.get_features(params), 3,
        cam, block, block_y, tight=True)
    inst = binning.bin_gaussians(pre, tiles_x, tiles_y, SETTINGS.capacity,
                                 SETTINGS.max_per_tile, chunk, pack_keys=True,
                                 precise_cull=True, block_x=block,
                                 block_y=block_y, width=w, height=h)
    packed = blend.pack_gather(blend.pack_instance_attrs_t(
        pre.means2d, pre.conic, pre.opacity, pre.rgb), inst.gid)
    return packed, inst, tiles_x


def _assert_jax_gate(got, want, same_card_rel=None):
    """The JAX seq gradient gate, row by row: atol 5e-4 * max|g|, rtol
    5e-3; with ``same_card_rel`` also max |d| <= same_card_rel * max|g|.
    Returns the largest error relative to its row's scale."""
    worst = 0.0
    for row in range(got.shape[0]):
        scale = want[row].abs().max().item() + 1e-12
        err = (got[row] - want[row]).abs()
        assert (err <= 5e-4 * scale + 5e-3 * want[row].abs()).all(), row
        if same_card_rel is not None:
            assert err.max().item() <= same_card_rel * scale, row
        worst = max(worst, err.max().item() / scale)
    return worst


@pytest.mark.cuda
def test_k1_matches_plain_version_on_gpu():
    """K1 vs its plain version on the same card and inputs. Built with
    --fmad=false, so only expf may round differently; the gate is the JAX
    seq kernel's (atol 5e-5, n_contrib equal on >= 99.9 %)."""
    _need_gpu()
    params, state, cam = demo.demo_scene(n=20_000, w=256, h=256,
                                         sh_degree=3)
    tiles_x, tiles_y = SETTINGS.tiles_for(cam.width, cam.height)
    pre = pp.preprocess_gaussians(
        params.xyz, gm.get_scaling(params), gm.get_rotation(params),
        gm.get_opacity(params, state.alive), gm.get_features(params), 3,
        cam, 32, 32, tight=True)
    inst = binning.bin_gaussians(pre, tiles_x, tiles_y, SETTINGS.capacity,
                                 SETTINGS.max_per_tile, 128, pack_keys=True,
                                 precise_cull=True, block_x=32, block_y=32,
                                 width=256, height=256)
    packed = blend.pack_gather(blend.pack_instance_attrs_t(
        pre.means2d, pre.conic, pre.opacity, pre.rgb), inst.gid)
    before = blend_seq.launches
    got = blend_seq.blend_seq_fwd(packed, inst.tile_start, inst.tile_count,
                                  tiles_x)
    torch.cuda.synchronize()
    assert blend_seq.launches == before + 1
    want = blend_seq.blend_tiles_seq_reference(
        packed, inst.tile_start, inst.tile_count, tiles_x)
    assert (got[:, :4] - want[:, :4]).abs().max().item() <= 5e-5
    assert (got[:, 4] == want[:, 4]).float().mean().item() >= 0.999
    off = blend_seq.blend_seq_fwd(packed, inst.tile_start, inst.tile_count,
                                  tiles_x, track_contrib=False)
    assert torch.equal(off[:, :4], got[:, :4]) and not off[:, 4].any()


@pytest.mark.cuda
def test_render_on_gpu_matches_cpu_render():
    """The whole forward path on the card (K1) vs the same path on the CPU
    (K1's plain version): same monitors, images within 1e-4."""
    _need_gpu()
    params, state, _ = demo.demo_scene(n=3000, w=96, h=80, sh_degree=3,
                                       device="cpu")
    gen = torch.Generator().manual_seed(1)
    params = params._replace(
        features_rest=0.2 * torch.randn(params.features_rest.shape,
                                        generator=gen),
        opacity=1.5 * torch.randn(params.opacity.shape, generator=gen))
    outs = {}
    for dev in ("cpu", "cuda"):
        cam = demo.demo_camera(96, 80, 0.4, device=dev)
        before = blend_seq.launches
        outs[dev] = render(cam, gm.GaussianParams(*(a.to(dev) for a in params)),
                           state.alive.to(dev), 3,
                           torch.tensor([0.2, 0.1, 0.3], device=dev), SETTINGS)
        assert blend_seq.launches == before + (dev == "cuda")
    cpu, gpu = outs["cpu"], outs["cuda"]
    assert (gpu["render"].cpu() - cpu["render"]).abs().max().item() <= 1e-4
    for key in ("num_rendered", "max_per_tile", "aligned_demand", "dropped",
                "culled"):
        assert int(gpu[key]) == int(cpu[key]), key


@pytest.mark.cuda
def test_k2_matches_plain_version_on_gpu():
    """K2 vs its plain version on the same card and inputs (256x256, 20k
    Gaussians), at the JAX gate and within 1e-5 of each row's scale: only
    the order of the pixel sums differs (3.0e-7 of a row's scale measured
    on an H100). Two launches agree bit for bit."""
    _need_gpu()
    packed, inst, tiles_x = _bench_like_inputs(20_000, 256, 256)
    args = (packed, inst.tile_start, inst.tile_count)
    raw = blend_seq.blend_seq_fwd(*args, tiles_x)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cot = torch.randn(raw.shape, generator=gen, device="cuda")
    before = blend_seq.bwd_launches
    got = blend_seq.blend_seq_bwd(*args, raw, cot, tiles_x)
    again = blend_seq.blend_seq_bwd(*args, raw, cot, tiles_x)
    torch.cuda.synchronize()
    assert blend_seq.bwd_launches == before + 2
    assert torch.equal(got, again)
    want = blend_seq.blend_tiles_seq_bwd_reference(*args, raw, cot, tiles_x)
    worst = _assert_jax_gate(got, want, same_card_rel=1e-5)
    print(f"K2 vs plain: max error / row scale {worst:.3e}")
    assert not got[:, ~inst.valid].any()


def _synthetic_tiles(counts, tiles_x, make, seed=0, block=32):
    """A (9, K) packed table whose tile t of ``block`` x ``block`` pixels
    holds ``counts[t]`` instances from ``make(n, x0, y0, gen, block)`` (9
    rows; x0, y0 the tile's corner), each tile's segment 128-aligned as
    binning lays it out; with tile_start, tile_count."""
    gen = torch.Generator().manual_seed(seed)
    starts, cols, k = [], [], 0
    for t, n in enumerate(counts):
        starts.append(k)
        cols.append(make(n, block * float(t % tiles_x),
                         block * float(t // tiles_x), gen, block))
        k += max(128, -(-n // 128) * 128)
    packed = torch.zeros((9, k))
    for s, c in zip(starts, cols):
        packed[:, s:s + c.shape[1]] = c
    as_int = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    return packed.cuda(), as_int(starts), as_int(list(counts))


def _uniform(gen, n, lo, hi):
    return lo + (hi - lo) * torch.rand(n, generator=gen)


def _faint(n, x0, y0, gen, block=32):
    """Wide splats of opacity 0.9/255-1.3/255 over the tile, their means
    within 8 px of a 32x32 square from its corner (whatever ``block``):
    alpha near the floor, so few pairs blend and no pixel finishes."""
    del block
    return torch.stack([
        x0 + _uniform(gen, n, -8, 40), y0 + _uniform(gen, n, -8, 40),
        _uniform(gen, n, 5e-4, 3e-3), _uniform(gen, n, -3e-4, 3e-4),
        _uniform(gen, n, 5e-4, 3e-3), _uniform(gen, n, 0.9, 1.3) / 255,
        *torch.rand((3, n), generator=gen)])


def _opaque(n, x0, y0, gen, block=32):
    """Wide splats of opacity 0.95-0.99: every pixel is done within the
    first few instances."""
    return torch.stack([
        x0 + _uniform(gen, n, 0, block), y0 + _uniform(gen, n, 0, block),
        _uniform(gen, n, 1e-4, 1e-3), torch.zeros(n),
        _uniform(gen, n, 1e-4, 1e-3), _uniform(gen, n, 0.95, 0.99),
        *torch.rand((3, n), generator=gen)])


def _threshold(n, x0, y0, gen, block=32):
    """Instances whose op * exp(power) lies at 1/255 to within a few ulps
    on some pixels of the tile: the first eighth flat (conic 0, power -0,
    op = 1/255 moved by -4..4 ulps), the rest far to the left with A set so
    that the power at the tile's middle column is ln(1/(255 op)) and moves
    by ~1 % of it across the tile, so that some pairs of each fall within
    a few ulps of the alpha floor and of the kernels' cutoff band."""
    op = _uniform(gen, n, 0.02, 1.0)
    dist = _uniform(gen, n, 3000, 6000)
    ln = torch.log(1 / 255 / op)
    flat = n // 8
    ulps = torch.arange(flat, dtype=torch.int32) % 9 - 4
    op[:flat] = (torch.full((flat,), 1 / 255).view(torch.int32)
                 + ulps).view(torch.float32)
    a = -2 * ln / (dist + block / 2) ** 2
    a[:flat] = 0.0
    return torch.stack([
        x0 - dist, y0 + _uniform(gen, n, 0, block), a, torch.zeros(n),
        torch.where(torch.arange(n) < flat, 0.0, 1e-7), op,
        *torch.rand((3, n), generator=gen)])


def _needles(n, x0, y0, gen, block=32):
    """Thin splats (0.3-1 px across, 20-200 px long) at every angle, up to
    B^2 = 0.9995 AC, opacity 0.3-0.99: the per-warp box test's edges and
    its guard against ill-conditioned conics."""
    s1 = _uniform(gen, n, 0.3, 1.0)
    s2 = _uniform(gen, n, 20.0, 200.0)
    theta = _uniform(gen, n, 0.0, math.pi)
    c, s = torch.cos(theta), torch.sin(theta)
    xx = c * c * s1 ** 2 + s * s * s2 ** 2
    yy = s * s * s1 ** 2 + c * c * s2 ** 2
    xy = c * s * (s1 ** 2 - s2 ** 2)
    det = xx * yy - xy * xy
    return torch.stack([
        x0 + _uniform(gen, n, -block / 2, block * 3 / 2),
        y0 + _uniform(gen, n, -block / 2, block * 3 / 2),
        yy / det, -xy / det, xx / det, _uniform(gen, n, 0.3, 0.99),
        *torch.rand((3, n), generator=gen)])


ADVERSARIAL = ["crowded", "contrib_off", "done_early", "threshold",
               "empty_tiles", "needles", "grid_25x19"]


def _adversarial_case(case, block=32):
    """(packed, tile_start, tile_count, tiles_x, track_contrib) with tiles
    of ``block`` x ``block`` pixels."""
    if case == "grid_25x19":
        packed, inst, tiles_x = _bench_like_inputs(
            20_000, 25 * block, 19 * block, block=block)
        assert inst.tile_count.numel() == 25 * 19
        return packed, inst.tile_start, inst.tile_count, tiles_x, True
    make, counts, tiles_x = {
        "crowded": (_faint, [4096, 0, 50, 300], 2),
        "contrib_off": (_faint, [4096, 0, 50, 300], 2),
        "done_early": (_opaque, [300, 300, 300, 300], 2),
        "threshold": (_threshold, [4096, 1024, 1024, 2000], 2),
        "empty_tiles": (_faint, [0, 200, 0, 0, 150, 0], 3),
        "needles": (_needles, [2000, 600, 600, 3000], 2),
    }[case]
    return (*_synthetic_tiles(counts, tiles_x, make, block=block), tiles_x,
            case != "contrib_off")


def _assert_adversarial_case(case, raw, count, track):
    """What each adversarial case must show in the forward's output."""
    stop = count if not track else torch.minimum(
        count, raw[:, 4].amax(dim=1).to(torch.int32))
    if case == "crowded":
        assert (raw[0, 3] > 1e-3).all() and int(stop[0]) > 3000
    if case == "done_early":
        # T freezes below 1e-4 / (1 - 0.99) once a pixel is done
        assert (raw[:, 3] < 0.01).all() and int(stop.max()) < 128
    if case == "empty_tiles":
        assert torch.equal(raw[count == 0, 3], torch.ones_like(
            raw[count == 0, 3])) and not raw[count == 0, :3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_k1_k2_adversarial_tiles_on_gpu(case):
    """K1 bit-equal to its plain version (color, T and n_contrib on every
    pixel) and K2 within 1e-5 of each row's scale and the JAX gate, two K2
    launches bit-equal, on: a tile crowded to max_per_tile 4096 whose
    pixels never finish; the same with track_contrib off (K2 walks to
    tile_count); tiles done within the first batch; op * exp(power) within
    a few ulps of 1/255, around the alpha-floor cutoff's margin; empty
    tiles; needle-thin splats at every angle, along the per-warp box
    test's edges; and a 25x19 grid of binned demo tiles (no multiple of
    four tiles)."""
    _need_gpu()
    packed, start, count, tiles_x, track = _adversarial_case(case)
    args = (packed, start, count, tiles_x, track)
    raw = blend_seq.blend_seq_fwd(*args)
    torch.cuda.synchronize()
    want = blend_seq.blend_tiles_seq_reference(*args)
    assert torch.equal(raw, want)
    _assert_adversarial_case(case, raw, count, track)

    gen = torch.Generator(device="cuda").manual_seed(1)
    cot = torch.randn(raw.shape, generator=gen, device="cuda")
    bwd_args = (packed, start, count, raw, cot, tiles_x, track)
    got = blend_seq.blend_seq_bwd(*bwd_args)
    again = blend_seq.blend_seq_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = blend_seq.blend_tiles_seq_bwd_reference(*bwd_args)
    worst = _assert_jax_gate(got, want, same_card_rel=1e-5)
    print(f"{case}: K2 vs plain max error / row scale {worst:.3e}")
    assert want.abs().amax() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("block_x, block_y, chunk, size", [
    (16, 16, 128, 256), (32, 32, 64, 256), (8, 8, 128, 256),
    (32, 16, 128, 256), (48, 40, 128, 256), (12, 12, 64, 256),
    (20, 20, 128, 256), (24, 24, 128, 256), (16, 12, 64, 256),
    (1, 1, 8, 48)],
    ids=["16-128", "32-64", "8x8-128", "32x16-128", "48x40-128",
         "12x12-64", "20x20-128", "24x24-128", "16x12-64", "1x1-8"])
def test_k4_k5_match_plain_versions_on_gpu(block_x, block_y, chunk, size):
    """K4 and K5 vs their plain versions on the same card and inputs
    (``size`` squared, 20k Gaussians): 16x16, 32x32 chunk 64 as a routed
    seq setting runs, 8x8 and 32x16 (warp patches), 48x40 (more warps than
    K5's patches allow: K5's row-major layout at 8 pixels per thread), 24x24
    (K4's cells in two blocks, K5 row-major at 4 pixels per thread), 20x20
    (K5 row-major at 2), 12x12, 16x12 and 1x1 (no patches: K4's and K5's
    row-major layouts). K4 bit-equal (color, T and n_contrib), K5 at the
    JAX gate and within 1e-5 of each row's scale. Two K5 launches agree bit
    for bit."""
    _need_gpu()
    packed, inst, tiles_x = _bench_like_inputs(
        20_000, size, size, block=block_x, chunk=chunk, block_y=block_y)
    args = (packed, inst.tile_start, inst.tile_count, tiles_x)
    fwd, bwd = blend_pallas.launches, blend_pallas.bwd_launches
    raw = blend_pallas.blend_pallas_fwd(*args, block_x, block_y)
    torch.cuda.synchronize()
    want = blend_pallas.blend_tiles_pallas_reference(*args, block_x, block_y)
    assert torch.equal(raw, want)
    off = blend_pallas.blend_pallas_fwd(*args, block_x, block_y,
                                        track_contrib=False)
    assert torch.equal(off[:, :4], raw[:, :4]) and not off[:, 4].any()

    gen = torch.Generator(device="cuda").manual_seed(0)
    cot = torch.randn(raw.shape, generator=gen, device="cuda")
    bwd_args = (packed, inst.tile_start, inst.tile_count, raw, cot, tiles_x,
                block_x, block_y)
    got = blend_pallas.blend_pallas_bwd(*bwd_args)
    again = blend_pallas.blend_pallas_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert blend_pallas.launches == fwd + 2
    assert blend_pallas.bwd_launches == bwd + 2
    assert torch.equal(got, again)
    want = blend_pallas.blend_tiles_pallas_bwd_reference(*bwd_args)
    worst = _assert_jax_gate(got, want, same_card_rel=1e-5)
    print(f"K5 vs plain at {block_x}x{block_y}: max error / row scale "
          f"{worst:.3e}")
    assert not got[:, ~inst.valid].any()
    # without n_contrib K5 walks every pixel to tile_count: the same sums
    off_args = (*bwd_args[:3], off, *bwd_args[4:], False)
    got_off = blend_pallas.blend_pallas_bwd(*off_args)
    want_off = blend_pallas.blend_tiles_pallas_bwd_reference(*off_args)
    _assert_jax_gate(got_off, want_off, same_card_rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_k4_k5_adversarial_tiles_on_gpu(case, block):
    """K4 bit-equal to its plain version (color, T and n_contrib on every
    pixel) and K5 within 1e-5 of each row's scale and the JAX gate, two K5
    launches bit-equal, on K1/K2's adversarial tile sets at 16x16 and 32x32
    tiles: a tile crowded to 4096 faint instances, the same with
    track_contrib off (K5 walks to tile_count), tiles done within the first
    batch, op * exp(power) within a few ulps of 1/255, empty tiles,
    needle-thin splats along the box test's edges, and a 25x19 grid of
    binned demo tiles."""
    _need_gpu()
    packed, start, count, tiles_x, track = _adversarial_case(case, block)
    args = (packed, start, count, tiles_x, block, block, track)
    raw = blend_pallas.blend_pallas_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(raw, blend_pallas.blend_tiles_pallas_reference(*args))
    _assert_adversarial_case(case, raw, count, track)

    gen = torch.Generator(device="cuda").manual_seed(1)
    cot = torch.randn(raw.shape, generator=gen, device="cuda")
    bwd_args = (packed, start, count, raw, cot, tiles_x, block, block, track)
    got = blend_pallas.blend_pallas_bwd(*bwd_args)
    again = blend_pallas.blend_pallas_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = blend_pallas.blend_tiles_pallas_bwd_reference(*bwd_args)
    worst = _assert_jax_gate(got, want, same_card_rel=1e-5)
    print(f"{case} at {block}x{block}: K5 vs plain max error / row scale "
          f"{worst:.3e}")
    assert want.abs().amax() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["seq", "pallas"])
def test_render_gradients_on_gpu_match_cpu(backend):
    """autograd through ``render`` on the card (K1 and K2, or K4 and K5) vs
    the same on the CPU (their plain versions) at 96x80, at the JAX gate."""
    _need_gpu()
    settings = SETTINGS if backend == "seq" else PALLAS
    params, state, _ = demo.demo_scene(n=3000, w=96, h=80, sh_degree=3,
                                       device="cpu")
    gen = torch.Generator().manual_seed(2)
    params = params._replace(
        features_rest=0.2 * torch.randn(params.features_rest.shape,
                                        generator=gen),
        opacity=1.5 * torch.randn(params.opacity.shape, generator=gen))
    target = torch.rand((3, 80, 96), generator=gen)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = gm.GaussianParams(*(a.detach().to(dev).requires_grad_()
                                     for a in params))
        out = render(demo.demo_camera(96, 80, 0.4, device=dev), leaves,
                     state.alive.to(dev), 3,
                     torch.tensor([0.2, 0.1, 0.3], device=dev), settings)
        ((out["render"] - target.to(dev)) ** 2).sum().backward()
        grads[dev] = [a.grad for a in (leaves.xyz, leaves.scaling,
                                       leaves.rotation, leaves.opacity,
                                       leaves.features_dc,
                                       leaves.features_rest)]
    for want, got in zip(grads["cpu"], grads["cuda"]):
        _assert_jax_gate(got.cpu().reshape(-1, 1).T,
                         want.reshape(-1, 1).T)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["seq", "pallas"])
def test_train_step_repeats_bit_for_bit_on_gpu(backend):
    """Two ``train_step``s from one state give the same bits: nothing on
    the gradient path sums in a run-dependent order."""
    _need_gpu()
    settings = SETTINGS if backend == "seq" else PALLAS
    params, state, cam = demo.demo_scene(n=20_000, w=256, h=256,
                                         sh_degree=3)
    with torch.no_grad():
        gt = render(cam, params, state.alive, 3, torch.zeros(3, device="cuda"),
                    SETTINGS)["render"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = params._replace(opacity=params.opacity + torch.randn(
        params.opacity.shape, generator=gen, device="cuda"))
    tx = optim.make_optimizer(optim.OptimizationParams(), 1.0)
    ts = loop.TrainState(params, state, tx.init(params), 0)
    launches = blend_pallas.launches
    outs = [loop.train_step(ts, cam, gt, torch.zeros(3, device="cuda"),
                            tx=tx, sh_degree=3, settings=settings,
                            lambda_dssim=0.2) for _ in range(2)]
    assert blend_pallas.launches - launches == 2 * (backend == "pallas")
    (a, ma), (b, mb) = outs
    assert torch.equal(ma["loss"], mb["loss"])
    for x, y in zip(a.params + a.gstate, b.params + b.gstate):
        assert torch.equal(x, y)
    for name in a.opt_state:
        assert torch.equal(a.opt_state[name].mu, b.opt_state[name].mu), name
        assert torch.equal(a.opt_state[name].nu, b.opt_state[name].nu), name


@pytest.mark.cuda
def test_train_entry_point_on_gpu(tmp_path):
    """The port's train entry point on a 64x64 scene its demo-scene tool
    renders: 30 iterations through K1 and K2 (once each per iteration, plus
    K1 for the evaluation renders), a finite loss, the model saved."""
    _need_gpu()
    from neuralgaussiansplatting_torch.tools import make_demo_scene
    from neuralgaussiansplatting_torch.train import __main__ as entry
    src, out = str(tmp_path / "scene"), str(tmp_path / "out")
    make_demo_scene.main(["--out", src, "--size", "64", "--views", "8",
                          "--n_gaussians", "2000", "--init_points", "1000"])
    k1, k2 = blend_seq.launches, blend_seq.bwd_launches
    summary = entry.main(["-s", src, "-m", out, "--eval", "--iterations",
                          "30", "--test_iterations", "30",
                          "--save_iterations", "30", "--disable_viewer",
                          "--quiet"])
    assert blend_seq.launches - k1 >= 30
    assert blend_seq.bwd_launches - k2 == 30
    assert math.isfinite(summary["last_loss"])
    assert set(summary["evals"][30]) == {"test", "train"}
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_30",
                                       "point_cloud.ply"))


@pytest.mark.cuda
def test_k3_matches_plain_version_on_gpu():
    """K3 vs its plain version on the same card and inputs: a random 256²
    scene (ids equal, depths bit-equal, also with each tile's instances
    shuffled, and the tiled idxmap equal to the per-pixel sort oracle), and
    two instances at equal depth on one pixel
    with ids past 2^25, where the lower id must win."""
    _need_gpu()
    params, state, cam = demo.demo_scene(n=20_000, w=256, h=256,
                                         sh_degree=1)
    args, _, demand = zbuffer_pallas.zbuf_inputs(params.xyz, cam, 1 << 17,
                                                 state.alive)
    idx = zbuffer_pallas.compute_idxmap_tiled(params.xyz, cam, 1 << 17,
                                              state.alive)[0]
    before = zbuffer_pallas.launches
    got = zbuffer_pallas.zbuf_tiles(*args)
    torch.cuda.synchronize()
    assert zbuffer_pallas.launches == before + 1
    want = zbuffer_pallas.zbuf_tiles_reference(*args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert int(demand) <= 1 << 17 and (got[0] >= 0).any()
    # each tile's instances in another order: the same ids and depth bits
    shuffled = zbuffer_pallas.zbuf_tiles(*k3_cases.shuffle_tiles(args, 3))
    assert torch.equal(shuffled[0], want[0])
    assert torch.equal(shuffled[1].view(torch.int32),
                       want[1].view(torch.int32))
    oracle, _, num_inst = idxmap_ops.compute_idxmap(params.xyz, cam, 1 << 20,
                                                    state.alive)
    assert int(num_inst) <= 1 << 20 and torch.equal(idx, oracle)

    lo, hi = (1 << 25) + 1, (1 << 25) + 2
    i32 = dict(dtype=torch.int32, device="cuda")
    rects = torch.tensor([[0, 0], [0, 0], [1, 1], [1, 1], [hi, lo]], **i32)
    gid, dmin = zbuffer_pallas.zbuf_tiles(
        rects, torch.full((2,), 2.0, device="cuda"),
        torch.zeros(1, **i32), torch.full((1,), 2, **i32), 1)
    assert gid[0, 0].item() == lo and dmin[0, 0].item() == 2.0
    assert (gid[0, 1:] == -1).all() and not dmin[0, 1:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(k3_cases.CASES))
def test_k3_adversarial_tiles_on_gpu(case):
    """K3 vs its plain version on ``k3_cases``' tile sets (a shuffled
    footprint scene of several staged batches a tile; a stack of equal
    depths with ids past 2^25; -0.0 beside +0.0, NaN, 3e38 and inf,
    negative depths and -inf; rects over whole tiles and across their
    edges; 2000 instances on one tile; empty tiles), in binning's order and
    in two shuffled orders: ids equal and depths bit-equal every time."""
    _need_gpu()
    make = k3_cases.CASES[case]
    want = zbuffer_pallas.zbuf_tiles_reference(*make())
    for seed in (None, 7, 8):
        before = zbuffer_pallas.launches
        gid, depth = zbuffer_pallas.zbuf_tiles(*make(seed=seed,
                                                     device="cuda"))
        torch.cuda.synchronize()
        assert zbuffer_pallas.launches == before + 1
        assert torch.equal(gid.cpu(), want[0]), seed
        assert torch.equal(depth.cpu().view(torch.int32),
                           want[1].view(torch.int32)), seed


@pytest.mark.cuda
def test_neural_paths_on_gpu_match_cpu():
    """render2 (K3, the decoders, the denoiser) on the card vs the CPU at
    64x64 with narrow decoders and cuDNN's TF32 off: the same idxmap, and
    the image and the features' gradient (through the decoders' float32
    convolutions, which sum in another order there) within 1e-5 of their
    scales."""
    _need_gpu()
    params, state, _ = demo.demo_scene(n=600, w=64, h=64, seed=3,
                                       sh_degree=1, device="cpu")
    gen = torch.Generator().manual_seed(4)
    params = params._replace(features=torch.randn(params.features.shape,
                                                  generator=gen))
    decoders = {"unet": nets.UNet(base_channels=8),
                "cnn": nets.CNN(mid_channels=16)}
    for module in decoders.values():
        nets.kaiming_init_(module, gen)
    cot = torch.randn((3, 64, 64), generator=gen)
    outs, grads = {}, {}
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            p = gm.GaussianParams(*(a.to(dev) for a in params))
            f = p.features.clone().requires_grad_()
            out = gr.render2(demo.demo_camera(64, 64, 0.3, device=dev),
                             p._replace(features=f),
                             {k: copy.deepcopy(m).to(dev)
                              for k, m in decoders.items()},
                             1 << 13, alive=state.alive.to(dev))
            (out["render"] * cot.to(dev)).sum().backward()
            outs.setdefault(dev, []).append(out)
            grads.setdefault(dev, []).append(f.grad.cpu())
    finally:
        cudnn.allow_tf32 = saved
    cpu, gpu = outs["cpu"][0], outs["cuda"][0]
    assert torch.equal(gpu["idxmap"].cpu(), cpu["idxmap"])
    want = cpu["render"].detach()
    assert ((gpu["render"].detach().cpu() - want).abs().max()
            <= 1e-5 * want.abs().max())
    g = grads["cpu"][0]
    assert (grads["cuda"][0] - g).abs().max() <= 1e-5 * g.abs().max()


def _k6_case(kind):
    """(starts, diffs, domain, f, fields or None) of a K6 case on the card,
    from a seeded generator."""
    gen = torch.Generator().manual_seed(11)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int64)

    if kind in ("make_case", "zero_length_runs"):
        n = 20_000 if kind == "make_case" else 100_000   # Poisson(0.5) runs
        starts, fields = decode_tool.make_case(n, 1 << 17, 6)
        return starts, k6.diffs_from_fields(fields), 1 << 17, 6, fields
    if kind == "domain_2_24":   # 4096 blocks: far more than are resident
        starts, fields = decode_tool.make_case(2_000_000, 1 << 24, 6)
        return starts, k6.diffs_from_fields(fields), 1 << 24, 6, fields
    if kind == "edge":
        # first start above 0, repeated starts on a block boundary, starts
        # at and past the domain, fields over the whole int32 range
        starts, fields = decode_tool.edge_case(3 * 4096, 6, n=3000)
        return starts, k6.diffs_from_fields(fields), 3 * 4096, 6, fields
    if kind == "crowded":   # 50k runs start in 64 slots: atomics on a row
        starts = torch.sort(ints(0, 64, (50_000,)))[0].to(torch.int32)
        diffs = ints(-2 ** 31, 2 ** 31, (50_000, 6)).to(torch.int32)
        return starts.cuda(), diffs.cuda(), 8192, 6, None
    if kind == "empty":
        return (torch.zeros(0, dtype=torch.int32, device="cuda"),
                torch.zeros((0, 6), dtype=torch.int32, device="cuda"), 4096,
                6, None)
    # "f13" and "f128": fewer slots per block; diffs wider than f
    f = int(kind[1:])
    starts = torch.sort(ints(0, 1 << 15, (5000,)))[0].to(torch.int32)
    diffs = ints(-2 ** 31, 2 ** 31, (5000, f + 3)).to(torch.int32)
    return starts.cuda(), diffs.cuda(), 1 << 15, f, None


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["make_case", "zero_length_runs", "edge",
                                  "crowded", "empty", "f13", "f128",
                                  "domain_2_24"])
def test_k6_matches_plain_version_on_gpu(kind):
    """K6 vs its plain version on the same card and inputs, bit for bit,
    and bit-equal across two launches; vs ``_expand_runs`` of the fields
    where the diffs are their row differences."""
    _need_gpu()
    starts, diffs, domain, f, fields = _k6_case(kind)
    before = k6.launches
    got = k6.decode_runs(starts, diffs, domain, f)
    again = k6.decode_runs(starts, diffs, domain, f)
    torch.cuda.synchronize()
    assert k6.launches == before + 2
    assert got.shape == (domain, f) and got.dtype == torch.int32
    assert torch.equal(got, again)
    assert torch.equal(got, k6.decode_runs_reference(starts, diffs, domain, f))
    if fields is not None:
        assert torch.equal(got, binning._expand_runs(fields, starts, domain))


@pytest.mark.cuda
def test_k6_repeats_over_100_calls_on_gpu():
    """100 back-to-back K6 calls at the decode tool's 800p workload on one
    stream (one status buffer, 100 sequence numbers): every output
    bit-equal to the plain version's."""
    _need_gpu()
    starts, fields = decode_tool.make_case(*decode_tool.WORKLOADS["800p"], 6)
    diffs = k6.diffs_from_fields(fields)
    domain = decode_tool.WORKLOADS["800p"][1]
    want = k6.decode_runs_reference(starts, diffs, domain, 6)
    outs = [k6.decode_runs(starts, diffs, domain, 6) for _ in range(100)]
    torch.cuda.synchronize()
    assert all(torch.equal(out, want) for out in outs)


@pytest.mark.cuda
def test_k6_on_two_streams_on_gpu():
    """K6 calls on two streams at once, each with its own inputs, ten each
    in turns: each stream keeps its own status buffer, and every output is
    bit-equal to its plain version's."""
    _need_gpu()
    domain = 1 << 22
    cases = [decode_tool.make_case(n, domain, 6, seed=seed)
             for n, seed in ((1_000_000, 1), (300_000, 2))]
    args = [(s, k6.diffs_from_fields(f)) for s, f in cases]
    wants = [k6.decode_runs_reference(s, d, domain, 6) for s, d in args]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    main = torch.cuda.current_stream()
    outs = [[], []]
    for st in streams:
        st.wait_stream(main)
    for _ in range(10):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(k6.decode_runs(*args[i], domain, 6))
    torch.cuda.synchronize()
    keys = {(torch.cuda.current_device(), st.cuda_stream) for st in streams}
    assert keys <= set(k6._states)
    for i in range(2):
        assert all(torch.equal(out, wants[i]) for out in outs[i])


@pytest.mark.cuda
def test_k7_probes_match_plain_versions_on_gpu():
    """Each K7 probe vs its plain version on the same card, exactly, on the
    tool's arange input and on a seeded input with |x| < 2^20 and a
    negative x[0, 0], on the current stream and on a stream of its own
    (the launch takes the current stream); the empty floor kernel launches
    and leaves the probe count as it was."""
    _need_gpu()
    gen = torch.Generator().manual_seed(5)
    rand = (torch.rand((16, 128), generator=gen) * 2 - 1) * 2 ** 20
    rand[0, 0] = -300.75
    side = torch.cuda.Stream()
    for x in (torch.arange(16 * 128, dtype=torch.float32).reshape(16, 128),
              rand):
        x = x.cuda()
        for name, (kernel, plain) in probes.PROBES.items():
            before = probes.launches
            got = kernel(x)
            torch.cuda.synchronize()
            assert probes.launches == before + 1, name
            assert torch.equal(got, plain(x)), name
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                again = kernel(x)
            side.synchronize()
            assert probes.launches == before + 2, name
            assert torch.equal(again, plain(x)), name
    before = probes.launches
    for _ in range(3):
        probes.launch_floor(x.device)
    torch.cuda.synchronize()
    assert probes.launches == before


def _demo_model(tmp_path, iterations):
    """(scene, model) of a 64x64 demo-tool scene trained ``iterations``
    iterations by the port's train entry point (checkpoint at the end)."""
    from neuralgaussiansplatting_torch.tools import make_demo_scene
    from neuralgaussiansplatting_torch.train import __main__ as entry
    src, out = str(tmp_path / "scene"), str(tmp_path / "out")
    make_demo_scene.main(["--out", src, "--size", "64", "--views", "8",
                          "--n_gaussians", "2000", "--init_points", "1000"])
    entry.main(["-s", src, "-m", out, "--eval", "--iterations",
                str(iterations), "--test_iterations", str(iterations),
                "--save_iterations", str(iterations),
                "--checkpoint_iterations", str(iterations),
                "--disable_viewer", "--quiet"])
    return src, out


@pytest.mark.cuda
@pytest.mark.parametrize("sw,mixed", [(1, False), (2, True), (3, False)])
def test_neural_entry_point_on_gpu(tmp_path, sw, mixed):
    """The port's neural entry point on a 64x64 demo-tool scene from the
    train entry point's checkpoint: 10 iterations through K3 (once per
    iteration, plus the evaluation and video renders), a finite loss and
    PSNR, the video frames, the feature statistics and the model saved."""
    _need_gpu()
    from neuralgaussiansplatting_torch import trainn
    src, out = _demo_model(tmp_path, 10)
    k3 = zbuffer_pallas.launches
    summary = trainn.main(
        ["-s", src, "-m", str(tmp_path / "neural"), "--eval", "--sw",
         str(sw), "--iterations", "10", "--test_iterations", "10",
         "--video_interval", "10", "--analysis_interval", "5",
         "--start_checkpoint", os.path.join(out, "chkpnt10.ckpt"), "--quiet"]
        + (["--mixed_precision"] if mixed else []))
    assert zbuffer_pallas.launches - k3 >= 10 + summary["video_frames"]
    assert summary["video_frames"] == 60
    assert math.isfinite(summary["last_loss"])
    assert all(math.isfinite(v) for split in summary["evals"][10].values()
               for v in split)
    neural = tmp_path / "neural"
    assert (neural / "point_cloud" / "iteration_10" /
            "point_cloud.ply").exists()
    assert (neural / "feature_analysis" / "history.csv").exists()
    assert len(os.listdir(neural / "video" / "iter_10" / "rgb")) == 60


@pytest.mark.cuda
def test_render_and_metrics_entry_points_on_gpu(tmp_path, monkeypatch):
    """The port's render and metrics entry points on a 30-iteration train
    run: K1 once per view (8 train, 2 test), no drops, the PNG trees, and
    finite SSIM, PSNR and LPIPS (seeded synthetic VGG weights)."""
    _need_gpu()
    from neuralgaussiansplatting_torch import metrics, render as render_entry
    from neuralgaussiansplatting_torch.utils import lpips
    _, out = _demo_model(tmp_path, 30)
    k1 = blend_seq.launches
    summary = render_entry.main(["-m", out])
    assert blend_seq.launches - k1 == 10
    assert summary["dropped"] == 0 and summary["iteration"] == 30
    for split, n in (("train", 8), ("test", 2)):
        for kind in ("renders", "gt"):
            assert len(os.listdir(os.path.join(out, split, "ours_30",
                                               kind))) == n

    rng = np.random.default_rng(0)
    weights, cin, li = {}, 3, 0
    for c, n_convs in lpips.VGG16_STAGES:
        for _ in range(n_convs):
            weights[f"conv{li}_w"] = (rng.normal(size=(3, 3, cin, c))
                                      * math.sqrt(2 / (9 * cin))).astype(
                                          np.float32)
            weights[f"conv{li}_b"] = np.zeros(c, np.float32)
            cin, li = c, li + 1
    for i, (c, _) in enumerate(lpips.VGG16_STAGES):
        weights[f"lin{i}_w"] = np.full(c, 1.0 / c, np.float32)
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **weights)
    monkeypatch.setenv("NGS_LPIPS_WEIGHTS", path)
    lpips._load_params.cache_clear()
    try:
        scores = metrics.main(["-m", out])[out]["ours_30"]
    finally:
        lpips._load_params.cache_clear()
    assert all(math.isfinite(scores[k]) for k in ("SSIM", "PSNR", "LPIPS"))


def _orbit(params, state, w, h, views=4, sh_degree=3):
    cams = [demo.demo_camera(w, h, 2 * math.pi * i / views)
            for i in range(views)]
    with torch.no_grad():
        gts = [render(c, params, state.alive, sh_degree,
                      torch.zeros(3, device="cuda"), SETTINGS)["render"]
               for c in cams]
    return cams, gts


@pytest.mark.cuda
def test_step_block_matches_steps_on_gpu():
    """``Trainer.step_block`` (3 blocks of 4) against 12 ``Trainer.step``s
    at 128x128 with a white background, its opacity reset at 4 and
    densification and tuning at 8 and 12 (block edges): the final state
    bit-equal."""
    _need_gpu()
    from neuralgaussiansplatting_torch.parallel.train_step import (
        stack_cameras)
    params, state, _ = demo.demo_scene(n=4000, w=128, h=128, sh_degree=3,
                                       capacity=8000)
    cams, gts = _orbit(params, state, 128, 128)
    opt = optim.OptimizationParams(densify_from_iter=4,
                                   densification_interval=4)

    def trainer():
        model = gm.GaussianModel(3)
        model.params = params._replace(opacity=params.opacity - 0.5)
        model.state = state
        return loop.Trainer(model, opt=opt, settings=SETTINGS,
                            white_background=True, cameras_extent=4.4,
                            tune_interval=4)

    a, b = trainer(), trainer()
    for it in range(1, 13):
        a.step(cams[it % 4], gts[it % 4], it)
    for first in (1, 5, 9):
        idx = [it % 4 for it in range(first, first + 4)]
        m = b.step_block(stack_cameras([cams[i] for i in idx]),
                         torch.stack([gts[i] for i in idx]), first)
    assert "densify" in m
    for x, y in zip(list(a.ts.params) + list(a.ts.gstate),
                    list(b.ts.params) + list(b.ts.gstate)):
        assert torch.equal(x, y)
    for name, g in a.ts.opt_state.items():
        assert torch.equal(g.mu, b.ts.opt_state[name].mu)
        assert torch.equal(g.nu, b.ts.opt_state[name].nu)


@pytest.mark.cuda
def test_strip_render_matches_monolithic_on_gpu():
    """256x320 in 5 strips of 64 rows (two 32-row tile rows each) through
    ``make_sharded_renderer`` on a 1 x 1 mesh: K1 once per strip, each
    strip bit-equal to the render of its strip camera, the strips'
    instances adding up to the frame's, and the image within the band gate
    of the monolithic render (max 0.05, mean 1e-3: the strip cameras round
    the Gaussians' pixel rows apart from the frame's)."""
    _need_gpu()
    from neuralgaussiansplatting_torch.parallel import mesh as mesh_lib
    from neuralgaussiansplatting_torch.parallel import render_sp
    params, state, cam = demo.demo_scene(n=20_000, w=256, h=320,
                                         sh_degree=3)
    bg = torch.zeros(3, device="cuda")
    renderer = render_sp.make_sharded_renderer(
        mesh_lib.make_mesh(), sh_degree=3, settings=SETTINGS, n_strips=5)
    with torch.no_grad():
        whole = render(cam, params, state.alive, 3, bg, SETTINGS)
        before = blend_seq.launches
        frame = renderer(cam, params, state.alive, bg)
        assert blend_seq.launches == before + 5
        strips = render_sp.strip_cameras(cam, 5)
        parts = [render(strips.camera(i), params, state.alive, 3, bg,
                        SETTINGS) for i in range(5)]
    assert torch.equal(frame, torch.cat([p["render"] for p in parts], 1))
    assert sum(int(p["num_rendered"]) for p in parts) == int(
        whole["num_rendered"])
    diff = (frame - whole["render"]).abs()
    assert diff.max() <= 0.05 and diff.mean() <= 1e-3


@pytest.mark.cuda
def test_dp_world1_stats_match_sequential_on_gpu():
    """One data-parallel step over 3 cameras (one process, no group) has
    the densification statistics of 3 single-camera iterations: denom and
    max radii exact, the accumulator at JAX's rtol 1e-4 / atol 1e-7."""
    _need_gpu()
    from neuralgaussiansplatting_torch.parallel import mesh as mesh_lib
    from neuralgaussiansplatting_torch.parallel.train_step import (
        make_dp_train_step, stack_cameras)
    from neuralgaussiansplatting_torch.train import densify as dens
    from neuralgaussiansplatting_torch.utils import losses
    params, state, _ = demo.demo_scene(n=4000, w=128, h=128, sh_degree=3)
    cams, gts = _orbit(params, state, 128, 128, views=3)
    start = params._replace(opacity=params.opacity - 0.5)
    tx = optim.make_optimizer(optim.OptimizationParams(), 1.0)
    bg = torch.zeros(3, device="cuda")
    step = make_dp_train_step(mesh_lib.make_mesh(), tx, sh_degree=3,
                              settings=SETTINGS)
    got, _ = step(loop.TrainState(start, state, tx.init(start), 0),
                  stack_cameras(cams), torch.stack(gts), bg)
    want = state
    for cam, gt in zip(cams, gts):
        off = start.xyz.new_zeros((start.xyz.shape[0], 2),
                                  requires_grad=True)
        out = render(cam, start, state.alive, 3, bg, SETTINGS,
                     means2d_offset=off)
        goff, = torch.autograd.grad(
            losses.photometric_loss(out["render"], gt, 0.2), [off])
        want = dens.add_densification_stats(want, out["radii"], goff)
    assert torch.equal(got.gstate.denom, want.denom)
    assert torch.equal(got.gstate.max_radii2d, want.max_radii2d)
    torch.testing.assert_close(got.gstate.xyz_gradient_accum,
                               want.xyz_gradient_accum, rtol=1e-4,
                               atol=1e-7)


@pytest.mark.cuda
def test_neural_step_repeats_on_gpu():
    """Two ``NeuralTrainer(sw=2)`` runs of 20 steps over 4 views at 128x128
    from the same seed: losses, decoders and features bit-equal; and the
    denoiser's gradient at 800x800 the same over 20 backward passes (its
    reflect padding once added with atomics)."""
    _need_gpu()
    from neuralgaussiansplatting_torch.train import neural_loop
    params, state, _ = demo.demo_scene(n=4000, w=128, h=128, sh_degree=1)
    gen = torch.Generator(device="cuda").manual_seed(21)
    params = params._replace(features=torch.randn(
        params.features.shape, generator=gen, device="cuda"))
    cams, gts = _orbit(params, state, 128, 128, sh_degree=1)

    def run():
        model = gm.GaussianModel(1)
        model.params, model.state = params, state
        trainer = neural_loop.NeuralTrainer(model, sw=2, capacity=1 << 16)
        loss = torch.stack([trainer.step(cams[s % 4], gts[s % 4])["loss"]
                            for s in range(20)])
        leaves = dict(neural_loop.decoder_leaves(trainer.ts.net_params),
                      features=trainer.ts.params.features)
        return loss, {k: v.detach().clone() for k, v in leaves.items()}

    (la, a), (lb, b) = run(), run()
    assert torch.equal(la, lb)
    for k in a:
        assert torch.equal(a[k], b[k]), k

    gen = torch.Generator(device="cuda").manual_seed(3)
    unet = torch.rand((800, 800, 3), generator=gen, device="cuda",
                      requires_grad=True)
    kernels = torch.rand((800, 800, 81), generator=gen, device="cuda")
    cot = torch.randn((800, 800, 3), generator=gen, device="cuda")
    first = torch.autograd.grad(nets.denoise(unet, kernels), unet, cot)[0]
    for _ in range(20):
        again = torch.autograd.grad(nets.denoise(unet, kernels), unet, cot)[0]
        assert torch.equal(first, again)


@pytest.mark.cuda
def test_quality_harnesses_on_gpu(tmp_path):
    """The quality-proof harness and the oracle's ``hold`` on a 64x64
    demo-tool scene of the proof's 40k-Gaussian mixture: K1 once per
    iteration and evaluation render, K2 once per iteration, the JSON
    written, and the oracle reading the mixture back at the GT-recovery
    level."""
    _need_gpu()
    import json
    from neuralgaussiansplatting_torch.tools import exp_quality_oracle
    from neuralgaussiansplatting_torch.tools import train_quality_proof
    scene, out = str(tmp_path / "scene"), str(tmp_path / "proof")
    argv = ["--scene", scene, "--out", out, "--iters", "30", "--size", "64",
            "--views", "8", "--init_points", "500"]
    train_quality_proof.generate(train_quality_proof.build_parser()
                                 .parse_args(argv))
    k1, k2 = blend_seq.launches, blend_seq.bwd_launches
    result = train_quality_proof.main(argv)
    # one evaluation (iteration 30) of 2 test and 5 train views
    assert blend_seq.launches - k1 == 30 + 7
    assert blend_seq.bwd_launches - k2 == 30
    assert result["launches"] == {"K1": 37, "K2": 30}
    with open(os.path.join(out, "quality_proof.json")) as f:
        written = json.load(f)
    assert [r["iteration"] for r in written["test_psnr"]] == [30]
    assert math.isfinite(written["test_psnr"][0]["psnr"])
    assert written["device"] == torch.cuda.get_device_name(0)
    assert written["peak_memory_bytes"] > 0

    k1, k2 = blend_seq.launches, blend_seq.bwd_launches
    rows = exp_quality_oracle.main(["hold", "--scene", scene, "--iters",
                                    "20"])["hold"]
    assert blend_seq.launches - k1 == 20 + 2 * 2
    assert blend_seq.bwd_launches - k2 == 20
    assert [r["iteration"] for r in rows] == [0, 20]
    assert all(r["psnr"] >= 40.0 for r in rows)


@pytest.mark.cuda
def test_bench_tools_on_gpu(tmp_path, monkeypatch):
    """The bench tools and stage timers on the card on clouds of a few
    thousand Gaussians, at their chained depths: each kernel launched once
    per chained step (chain runs (reps + 1) * (iters + 1) steps), the
    probes' renders besides, finite times, no drops."""
    _need_gpu()
    import json
    from neuralgaussiansplatting_torch import bench
    from neuralgaussiansplatting_torch.tools import bench_garden
    from neuralgaussiansplatting_torch.tools import bench_suite
    from neuralgaussiansplatting_torch.tools import exp_binning_micro
    from neuralgaussiansplatting_torch.tools import exp_bwd_micro
    from neuralgaussiansplatting_torch.tools import exp_neural_micro
    from neuralgaussiansplatting_torch.tools import exp_stage_micro

    def steps(iters, reps):
        return (reps + 1) * (iters + 1)

    def small(**kw):
        return demo.demo_scene(**{**kw, "n": 4000})

    res = bench.run(*small(w=800, h=800, sh_degree=3))
    n = steps(bench.ITERS, bench.REPS)
    assert res["launches"] == {"K1": n, "K2": n}
    assert math.isfinite(res["value"]) and res["value"] > 0

    monkeypatch.setattr(bench_suite, "demo_scene", small)
    out = str(tmp_path / "suite.json")
    results = bench_suite.main(["--out", out])
    fb = steps(bench_suite.ITERS, bench_suite.REPS)
    assert [r["launches"] for r in results] == [
        {"K1": fb, "K2": fb}, {"K1": fb, "K2": fb}, {"K1": 1 + fb},
        {"K3": steps(bench_suite.NEURAL_ITERS, bench_suite.REPS)}]
    with open(out) as f:
        assert json.load(f) == results

    cloud = bench_garden.garden_cloud(20_000, device="cuda")
    fwd = steps(bench_garden.FWD_ITERS, bench_garden.REPS)
    fb = steps(bench_garden.FWDBWD_ITERS, bench_garden.REPS)
    for mode in bench_garden.MODES:
        res = bench_garden.run(*cloud, mode)
        kf, kb = ("K4", "K5") if mode == "scatter" else ("K1", "K2")
        assert res["launches"] == {kf: 2 + fwd + fb, kb: fb}, mode
        assert res["monitors"]["dropped"] == 0 or mode == "dense"
        assert res["peak_memory_bytes"] > 0
        assert res["device"] == torch.cuda.get_device_name(0)

    scene = small(w=800, h=800, sh_degree=3)
    c8 = steps(exp_stage_micro.ITERS, exp_stage_micro.REPS)
    res = exp_stage_micro.run(*scene)
    assert res["launches"] == {"K4": 5 * c8, "K5": 4 * c8}
    res = exp_stage_micro.run(*scene, seq=True)
    assert res["launches"] == {"K1": 5 * c8, "K2": 4 * c8}
    res = exp_bwd_micro.run(*scene)
    assert res["launches"] == {"K1": 1, "K2": 1 + c8}
    res = exp_neural_micro.run(*scene)
    assert res["launches"] == {"K3": 6 * steps(exp_neural_micro.ITERS,
                                               exp_neural_micro.REPS)}
    for tool_res in (exp_binning_micro.run(*scene),
                     exp_binning_micro.run(*scene, variants=True)):
        assert tool_res["launches"] == {}
        assert all(r["ms"] is None or (math.isfinite(r["ms"]) and r["ms"] > 0)
                   for r in tool_res["rows"])
