"""The binning kernels (``csrc/binning.cu``) on the card,
against the plain version (``bin_gaussians_reference``) run on the same
card inputs: every ``Instances`` field equal, for "scatter" / "dense" x
``pack_keys`` x ``precise_cull``, at a garden-sized frame (5M Gaussians,
1297x840, 32x32 tiles), at the neural z-buffer's call (300k Gaussians,
800x800, packed keys, as ``zbuffer_pallas.zbuf_inputs`` makes it), with a
raw demand past ``capacity`` (truncation) and with a ``packed_capacity``
that drops whole tiles. Then a garden render bit-identical with the
kernels and with the plain binning, the sort alone against a stable
``torch.sort``, no host read inside ``bin_gaussians``, and
``binning.launches`` moving once a call.

This file imports no JAX, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_binning_cuda.py
"""

import functools

import pytest
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops import zbuffer_pallas as zb

GARDEN = (5_000_000, 1297, 840)
OPTIONS = [(pack, cull, expand) for expand in ("scatter", "dense")
           for pack in (False, True) for cull in (False, True)]
IDS = [f"{e}-{'packed' if p else 'exact'}-{'cull' if c else 'all'}"
       for p, c, e in OPTIONS]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on an NVIDIA GPU")


def cloud(n: int, seed: int = 3) -> dict:
    """``n`` Gaussians drawn on the card: means in the cube the demo scene
    fills, log-normal scales, random quaternions and opacities, SH 3."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda", generator=g)
    return {"means3d": torch.rand((n, 3), **dev) * 2.4 - 1.2,
            "scales": torch.exp(torch.randn((n, 3), **dev) * 0.6 - 4.6),
            "rotations": torch.randn((n, 4), **dev),
            "opacities": torch.sigmoid(torch.randn((n,), **dev)),
            "shs": torch.randn((n, 16, 3), **dev) * 0.3}


@functools.cache
def garden_pre():
    """The preprocess kernels' output for a garden-sized frame, as the
    garden cells bin it (32x32 tiles, tight rects), and its tiles."""
    n, w, h = GARDEN
    c = cloud(n)
    cam = demo.demo_camera(w, h)
    with torch.no_grad():
        pre = pp.preprocess_gaussians(
            c["means3d"], c["scales"], c["rotations"], c["opacities"],
            c["shs"], 3, cam, 32, 32, tight=True)
    return pre, -(-w // 32), -(-h // 32), w, h


def sized(pre) -> tuple[int, int]:
    """(capacity, packed capacity) by the benchmark's probe rule."""
    demand = int(pre.tiles_touched.sum())
    return (1 << int(demand * 1.15).bit_length(),
            ((int(demand * 1.3) >> 17) + 1) << 17)


def assert_same(pre, *args, **kw):
    """The kernels and the plain version on the same inputs: every field
    equal; the counter moves once. Returns the plain version's result."""
    before = binning.launches
    got = binning.bin_gaussians(pre, *args, **kw)
    assert binning.launches == before + 1
    want = binning.bin_gaussians_reference(pre, *args, **kw)
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if not torch.equal(g, w):
            bad = (g != w).reshape(-1).nonzero()[:8].flatten().tolist()
            pytest.fail(f"{name} differs at {bad}: got "
                        f"{g.reshape(-1)[bad].tolist()}, plain "
                        f"{w.reshape(-1)[bad].tolist()}")
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("pack,cull,expand", OPTIONS, ids=IDS)
def test_garden_frame_matches_plain_version(pack, cull, expand):
    _need_gpu()
    pre, tx, ty, w, h = garden_pre()
    cap, kcap = sized(pre)
    want = assert_same(pre, tx, ty, cap, 4096, 128, pack_keys=pack,
                       packed_capacity=kcap, precise_cull=cull, block_x=32,
                       block_y=32, width=w, height=h, expand=expand)
    assert int(want.num_rendered) > 4_000_000
    if cull:
        assert int(want.culled) > 0


@pytest.fixture(scope="module")
def neural_call():
    """``zbuffer_pallas.zbuf_inputs``' own call of ``bin_gaussians``
    (``zbuffer_pallas.binning_call``) at 300k Gaussians, 800x800, its
    capacity 524,288: (pre, args, kw)."""
    _need_gpu()
    c = cloud(300_000, seed=9)
    return zb.binning_call(c["means3d"], demo.demo_camera(800, 800),
                           1 << 19)[:3]


@pytest.mark.cuda
@pytest.mark.parametrize("pack,cull,expand", OPTIONS, ids=IDS)
def test_neural_zbuffer_call_matches_plain_version(neural_call, pack, cull,
                                                   expand):
    pre, args, kw = neural_call
    assert kw["pack_keys"] and not kw["precise_cull"]
    kw = kw | dict(pack_keys=pack, precise_cull=cull, expand=expand)
    want = assert_same(pre, *args, **kw)
    assert int(want.num_rendered) > 100_000


@pytest.mark.cuda
@pytest.mark.parametrize("pack,cull,expand", OPTIONS, ids=IDS)
def test_truncation_matches_plain_version(pack, cull, expand):
    """A raw demand past ``capacity`` ("scatter") or past ``dense_cap``
    ("dense"): the truncated instances and the monitors agree."""
    _need_gpu()
    pre, tx, ty, w, h = garden_pre()
    demand = int(pre.tiles_touched.sum())
    want = assert_same(pre, tx, ty, demand // 2, 4096, 128, pack_keys=pack,
                       packed_capacity=demand, precise_cull=cull,
                       block_x=32, block_y=32, width=w, height=h,
                       expand=expand, dense_cap=2)
    assert int(want.dropped) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pack,cull,expand", OPTIONS, ids=IDS)
def test_whole_tile_drops_match_plain_version(pack, cull, expand):
    """A ``packed_capacity`` well under the aligned demand, and a
    ``max_per_tile`` that caps the densest tiles."""
    _need_gpu()
    pre, tx, ty, w, h = garden_pre()
    cap, _ = sized(pre)
    want = assert_same(pre, tx, ty, cap, 2048, 128, pack_keys=pack,
                       packed_capacity=1 << 20, precise_cull=cull,
                       block_x=32, block_y=32, width=w, height=h,
                       expand=expand)
    assert int(want.aligned_demand) > 1 << 20 and int(want.dropped) > 0
    assert int(want.max_tile_load) > 2048


@pytest.mark.cuda
def test_garden_render_is_bit_identical_with_plain_binning(monkeypatch):
    _need_gpu()
    n, w, h = GARDEN
    c = cloud(n)
    cam = demo.demo_camera(w, h)
    pre = garden_pre()[0]
    cap, kcap = sized(pre)
    settings = rast.make_settings(
        "seq", tight_culling=True, precise_cull=True, expand="auto",
        fast_sort=False, capacity=cap, packed_capacity=kcap,
        max_per_tile=1 << 16)
    bg = torch.zeros(3, device="cuda")
    args = (c["means3d"], c["scales"], c["rotations"], c["opacities"],
            c["shs"], 3, cam, bg, settings)
    with torch.no_grad():
        before = binning.launches
        got = rast.rasterize(*args)
        assert binning.launches == before + 1
        monkeypatch.setattr(binning, "bin_gaussians",
                            binning.bin_gaussians_reference)
        want = rast.rasterize(*args)
    assert int(want.dropped) == 0
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bits", [(torch.int64, 42), (torch.int64, 9),
                                        (torch.int32, 31), (torch.int32, 3)])
def test_the_sort_alone_is_a_stable_sort(dtype, bits):
    """Random keys of ``bits`` bits (few distinct values at 3 and 9 bits:
    long runs of ties), a live count short of the buffer: the kernels'
    order is ``torch.sort(stable=True)``'s."""
    _need_gpu()
    domain, live = 3_000_001, 2_345_679
    g = torch.Generator(device="cuda").manual_seed(bits)
    keys = torch.randint(0, 1 << bits, (domain,), generator=g,
                         device="cuda", dtype=torch.int64).to(dtype)
    want_keys, want_idx = torch.sort(keys[:live], stable=True)
    count = torch.tensor([live], dtype=torch.int32, device="cuda")
    got_keys, got_idx = binning.radix_sort(keys.clone(), count, bits)
    assert torch.equal(got_keys[:live], want_keys)
    assert torch.equal(got_idx[:live].long(), want_idx)


@pytest.mark.cuda
def test_binning_reads_nothing_back_to_the_host():
    _need_gpu()
    pre, tx, ty, w, h = garden_pre()
    cap, kcap = sized(pre)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for expand in ("scatter", "dense"):
            binning.bin_gaussians(pre, tx, ty, cap, 4096, 128,
                                  packed_capacity=kcap, precise_cull=True,
                                  block_x=32, block_y=32, width=w, height=h,
                                  expand=expand)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
