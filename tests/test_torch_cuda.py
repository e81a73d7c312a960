"""The port's CUDA kernels on the card, against their plain versions.

This file imports no JAX, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The ``cuda`` tests skip where no CUDA device is present (a CUDA kernel has
no CPU mode); the rest check the build recipe on any host.
"""

import copy
import os

import pytest
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch import gaussian_renderer as gr
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.models import nets
from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import binning
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
    names = ("blend_seq_fwd", "blend_seq_bwd", "zbuffer_fwd",
             "blend_pallas_fwd", "blend_pallas_bwd", "decode_runs",
             "mosaic_probe")
    for name in names:
        src, lib = _build._target(name)
        assert os.path.exists(src)
        assert os.path.dirname(lib) == _build.BUILD_DIR
        assert lib == _build._target(name)[1]
        libs.add(lib)
    assert len(libs) == len(names)


def _bench_like_inputs(n, w, h, device="cuda", block=32, chunk=128):
    """Preprocess -> bin -> pack of the demo cloud, as ``rasterize`` runs
    them: K1's and K2's inputs at 32x32 tiles with chunk 128, K4's and
    K5's at any ``block`` and ``chunk``."""
    params, state, cam = demo.demo_scene(n=n, w=w, h=h, sh_degree=3,
                                         device=device)
    tiles_x, tiles_y = (w + block - 1) // block, (h + block - 1) // block
    pre = pp.preprocess_gaussians(
        params.xyz, gm.get_scaling(params), gm.get_rotation(params),
        gm.get_opacity(params, state.alive), gm.get_features(params), 3,
        cam, block, block, tight=True)
    inst = binning.bin_gaussians(pre, tiles_x, tiles_y, SETTINGS.capacity,
                                 SETTINGS.max_per_tile, chunk, pack_keys=True,
                                 precise_cull=True, block_x=block,
                                 block_y=block, width=w, height=h)
    packed = blend_pallas.pack_gather(blend_pallas.pack_instance_attrs_t(
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
    packed = blend_pallas.pack_gather(blend_pallas.pack_instance_attrs_t(
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


@pytest.mark.cuda
@pytest.mark.parametrize("block, chunk", [(16, 128), (32, 64)])
def test_k4_k5_match_plain_versions_on_gpu(block, chunk):
    """K4 and K5 vs their plain versions on the same card and inputs
    (256x256, 20k Gaussians): K4 at K1's gate (atol 5e-5, n_contrib equal
    on >= 99.9 %), K5 at the JAX gate and within 1e-5 of each row's scale.
    Two K5 launches agree bit for bit."""
    _need_gpu()
    packed, inst, tiles_x = _bench_like_inputs(20_000, 256, 256, block=block,
                                               chunk=chunk)
    args = (packed, inst.tile_start, inst.tile_count, tiles_x)
    fwd, bwd = blend_pallas.launches, blend_pallas.bwd_launches
    raw = blend_pallas.blend_pallas_fwd(*args, block, block)
    torch.cuda.synchronize()
    want = blend_pallas.blend_tiles_pallas_reference(*args, block, block)
    assert (raw[:, :4] - want[:, :4]).abs().max().item() <= 5e-5
    assert (raw[:, 4] == want[:, 4]).float().mean().item() >= 0.999
    off = blend_pallas.blend_pallas_fwd(*args, block, block,
                                        track_contrib=False)
    assert torch.equal(off[:, :4], raw[:, :4]) and not off[:, 4].any()

    gen = torch.Generator(device="cuda").manual_seed(0)
    cot = torch.randn(raw.shape, generator=gen, device="cuda")
    bwd_args = (packed, inst.tile_start, inst.tile_count, raw, cot, tiles_x,
                block, block)
    got = blend_pallas.blend_pallas_bwd(*bwd_args)
    again = blend_pallas.blend_pallas_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert blend_pallas.launches == fwd + 2
    assert blend_pallas.bwd_launches == bwd + 2
    assert torch.equal(got, again)
    want = blend_pallas.blend_tiles_pallas_bwd_reference(*bwd_args)
    worst = _assert_jax_gate(got, want, same_card_rel=1e-5)
    print(f"K5 vs plain at {block}x{block}: max error / row scale "
          f"{worst:.3e}")
    assert not got[:, ~inst.valid].any()


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
def test_k3_matches_plain_version_on_gpu():
    """K3 vs its plain version on the same card and inputs: a random 256²
    scene (ids equal, depths bit-equal, and the tiled idxmap equal to the
    per-pixel sort oracle), and two instances at equal depth on one pixel
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
                                  "crowded", "empty", "f13", "f128"])
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
def test_k7_probes_match_plain_versions_on_gpu():
    """Each K7 probe vs its plain version on the same card, exactly, on the
    tool's arange input and on a seeded input with |x| < 2^20 and a
    negative x[0, 0]."""
    _need_gpu()
    gen = torch.Generator().manual_seed(5)
    rand = (torch.rand((16, 128), generator=gen) * 2 - 1) * 2 ** 20
    rand[0, 0] = -300.75
    for x in (torch.arange(16 * 128, dtype=torch.float32).reshape(16, 128),
              rand):
        x = x.cuda()
        for name, (kernel, plain) in probes.PROBES.items():
            before = probes.launches
            got = kernel(x)
            torch.cuda.synchronize()
            assert probes.launches == before + 1, name
            assert torch.equal(got, plain(x)), name
