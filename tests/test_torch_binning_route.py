"""The binning route on the CPU, and the binning kernels' expansion built for
the host.

``bin_gaussians`` runs its CUDA kernels only for CUDA tensors; here, on the
CPU, it must be its plain version bit for bit, with ``binning.launches``
left as it was. The expansion's per-Gaussian functions
(``csrc/binning_common.cuh``: the tile walk, the cull decision, the keys)
are plain C++ under the stand-in ``cuda_runtime.h`` of
``tests/preprocess_host``: built with g++ (``-ffp-contract=off``, as nvcc's
``--fmad=false``) they run here against the plain version, whose keep
decisions, kept counts, starts and order they must give bit for bit, for
every ``pack_keys`` x ``precise_cull`` x ``expand``. The whole route then
runs with its C entry stood in for by that expansion, a stable numpy sort
and numpy ranges, to hold the wrapper's buffers and arguments.
Inputs are the plain preprocess of a seeded case (``preprocess_cases``).
No JAX here; the card tests are ``tests/test_torch_binning_cuda.py``.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import preprocess as pp

import preprocess_cases as cases

torch.set_num_threads(2)

W, H, N, BLOCK = 160, 120, 3000, 16
TX, TY = W // BLOCK, -(-H // BLOCK)
HERE = os.path.dirname(os.path.abspath(__file__))
OPTIONS = [(pack, cull, expand) for pack in (False, True)
           for cull in (False, True) for expand in ("scatter", "dense")]
OPTION_IDS = [f"{'packed' if p else 'exact'}-{'cull' if c else 'all'}-{e}"
              for p, c, e in OPTIONS]
ROOMY = dict(capacity=1 << 16, max_per_tile=1 << 16, align=32)


def _pre(seed: int = 7) -> pp.Preprocessed:
    cam = cases.camera(W, H, "cpu")
    case = cases.make_case(N, 3, seed, cam)
    with torch.no_grad():
        return cases.run_pass(pp.preprocess_gaussians_reference, case, cam,
                              BLOCK, False, False)


def _kw(pack, cull, expand, dense_cap=16, **caps):
    caps = ROOMY | caps
    return dict(tiles_x=TX, tiles_y=TY, capacity=caps["capacity"],
                max_per_tile=caps["max_per_tile"], align=caps["align"],
                pack_keys=pack, precise_cull=cull, block_x=BLOCK,
                block_y=BLOCK, width=W, height=H, expand=expand,
                dense_cap=dense_cap,
                packed_capacity=caps.get("packed_capacity"))


def _equal(got: binning.Instances, want: binning.Instances):
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("pack,cull,expand", OPTIONS[::3],
                         ids=OPTION_IDS[::3])
def test_cpu_tensors_take_the_plain_version(pack, cull, expand):
    pre = _pre()
    before = binning.launches
    kw = _kw(pack, cull, expand, capacity=4096, packed_capacity=6144)
    _equal(binning.bin_gaussians(pre, **kw),
           binning.bin_gaussians_reference(pre, **kw))
    assert binning.launches == before


def test_the_wrapper_refuses_what_the_kernels_do_not_take():
    pre = _pre()
    with pytest.raises(ValueError, match="device meta"):
        binning.bin_gaussians(pre._replace(tiles_touched=torch.empty(
            N, dtype=torch.int32, device="meta")), **_kw(False, False,
                                                        "scatter"))
    assert len(binning.card_inputs(pre, True)) == 7
    assert binning.card_inputs(pre, False)[4:] == (None, None, None)
    bad = [("tiles_touched", pre.tiles_touched.long()),
           ("rect_min", pre.rect_min[:, :1].contiguous()),
           ("depths", pre.depths.double()),
           ("depths", pre.depths.to("meta")),
           ("conic", pre.conic[:-1])]
    for name, value in bad:
        with pytest.raises(ValueError, match=name):
            binning.card_inputs(pre._replace(**{name: value}), True)
    # the cull's inputs are read, and checked, only under precise_cull
    binning.card_inputs(pre._replace(conic=pre.conic[:-1]), False)
    for caps in (dict(capacity=0), dict(packed_capacity=1 << 31),
                 dict(align=0)):
        with pytest.raises(ValueError, match="binning kernels take"):
            binning._bin_on_card(pre, *_args(False, False, "scatter", caps))
    with pytest.raises(ValueError, match="radix_sort"):
        binning.radix_sort(torch.zeros(8, dtype=torch.int16),
                           torch.zeros(1, dtype=torch.int32), 8)


def _args(pack, cull, expand, caps=None, dense_cap=16):
    kw = _kw(pack, cull, expand, dense_cap, **(caps or {}))
    return (kw["tiles_x"], kw["tiles_y"], kw["capacity"], kw["max_per_tile"],
            kw["align"], pack, kw["packed_capacity"], cull, BLOCK, BLOCK, W,
            H, expand, dense_cap)


def test_key_layout_and_passes():
    assert binning.key_layout(41 * 27, False) == (42, 31)
    assert binning.key_layout(41 * 27, True) == (31, 31 - 11)
    assert binning.key_layout(25 * 25, True) == (31, 31 - 10)
    assert binning.key_layout(1, False) == (31, 31)
    assert [binning.sort_passes(b) for b in (31, 32, 33, 42)] == [4, 4, 5, 6]


def test_the_kernels_are_part_of_the_build():
    src, lib = _build._target("binning")
    assert os.path.exists(src)
    assert os.path.dirname(lib) == _build.BUILD_DIR
    for part in ("common", "expand", "sort", "pack"):
        assert os.path.exists(os.path.join(_build.CSRC,
                                           f"binning_{part}.cuh"))


# --- the expansion's arithmetic, built for the host --------------------------

@pytest.fixture(scope="module")
def host_expand(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the expansion's "
                    "per-Gaussian functions")
    lib = str(tmp_path_factory.mktemp("binning_host") / "libexpand.so")
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", os.path.join(HERE, "preprocess_host"),
                    "-I", _build.CSRC, "-o", lib,
                    os.path.join(HERE, "binning_host", "expand.cpp")],
                   check=True, capture_output=True, text=True, timeout=300)
    fn = ctypes.CDLL(lib).host_binning_expand
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 7 + [ll] + [i] * 5 + [ll] + [i] * 5 + [p] * 6
    fn.restype = ctypes.c_int
    return fn


def _expand_on_host(fn, pre, pack, cull, expand, capacity, dense_cap=16):
    """The host expansion through the arguments the wrapper gives the
    ``binning`` entry: (stats, live, gcount, gstart, keys, gid_of)."""
    n = pre.tiles_touched.shape[0]
    domain = n * dense_cap if expand == "dense" else capacity
    ins = binning.card_inputs(pre, cull)
    stats = torch.zeros(3, dtype=torch.int64)
    live = torch.zeros(1, dtype=torch.int32)
    gcount = torch.zeros(n, dtype=torch.int32)
    gstart = torch.zeros(n, dtype=torch.int32)
    keys = torch.zeros(domain, dtype=torch.int32 if pack else torch.int64)
    gid_of = torch.zeros(domain, dtype=torch.int32)
    fn(*(None if t is None else t.data_ptr() for t in ins), n, TX, BLOCK,
       BLOCK, W, H, capacity, int(expand == "dense"), dense_cap,
       int(cull), int(not pack), binning.key_layout(TX * TY, pack)[1],
       stats.data_ptr(), live.data_ptr(), keys.data_ptr(), gid_of.data_ptr(),
       gcount.data_ptr(), gstart.data_ptr())
    return stats, int(live), gcount, gstart, keys, gid_of


@pytest.mark.parametrize("capacity,dense_cap", [(1 << 16, 16), (3000, 3)],
                         ids=["roomy", "truncated"])
@pytest.mark.parametrize("pack,cull,expand", OPTIONS, ids=OPTION_IDS)
def test_the_expansion_matches_the_plain_version(host_expand, pack, cull,
                                                 expand, capacity, dense_cap):
    """Keep decisions, kept counts and starts, each kept instance's gid,
    tile and key by its rank (eid), and the key's stable order against the
    plain version's: every kept instance lands in a packed slot (roomy
    packed capacity and max_per_tile), so the plain version's slots list
    them all. ``truncated`` cuts the scatter domain and the dense rows."""
    pre = _pre()
    stats, live, gcount, gstart, keys, gid_of = _expand_on_host(
        host_expand, pre, pack, cull, expand, capacity, dense_cap)
    want = binning.bin_gaussians_reference(
        pre, **_kw(pack, cull, expand, dense_cap, capacity=capacity,
                   packed_capacity=1 << 17))
    assert int(want.dropped) == int(stats[1]) and live > 1000
    assert torch.equal(gcount, want.gcount)
    assert torch.equal(gstart, want.gstart)
    assert int(stats[0]) == int(want.num_rendered)
    assert int(stats[0] - stats[1] - stats[2]) == int(want.culled)
    if cull:
        assert int(want.culled) > 0
    if dense_cap == 3:
        assert int(stats[1]) > 0
    valid = want.valid
    eid = want.eid[valid].long()
    tile = torch.repeat_interleave(torch.arange(TX * TY), want.tile_count)
    assert eid.numel() == live
    assert torch.equal(gid_of[eid], want.gid[valid])
    bits, shift = binning.key_layout(TX * TY, pack)
    k = keys[:live].long()
    assert torch.equal(k[eid] >> shift, tile)
    depth = pre.depths.view(torch.int32).long()[gid_of[:live].long()]
    low = depth >> (TX * TY + 1).bit_length() if pack else depth
    assert torch.equal(k & ((1 << shift) - 1), low)
    assert int(k.max()) < 1 << bits
    order = np.argsort(k.numpy(), kind="stable")
    assert torch.equal(gid_of[torch.from_numpy(order)], want.gid[valid])


# --- the whole route, its C entries stood in for on the host -----------------

def _at(ptr, dtype, count):
    ctype = {np.int32: ctypes.c_int32, np.int64: ctypes.c_int64,
             np.bool_: ctypes.c_bool}[dtype]
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _sort_on_host(ka, kb, va, vb, live, domain, bits, wide):
    """The sort as the entry leaves it: in (ka, va) after an even number of
    passes, else in (kb, vb); returns that pair."""
    m = int(_at(live, np.int32, 1)[0])
    kt = np.int64 if wide else np.int32
    keys = _at(ka, kt, domain)[:m].copy()
    order = np.argsort(keys & ((1 << bits) - 1), kind="stable")
    k_out, v_out = (ka, va) if binning.sort_passes(bits) % 2 == 0 \
        else (kb, vb)
    _at(k_out, kt, domain)[:m] = keys[order]
    _at(v_out, np.int32, domain)[:m] = order
    return k_out, v_out


def _pack_on_host(keys, wide, shift, sorted_eid, gid_of, live, domain,
                  num_tiles, kcap, max_per_tile, align, n, stats, tile_lo,
                  tile_start, tile_count, gid, valid, eid, monitors):
    m = int(_at(live, np.int32, 1)[0])
    k = _at(keys, np.int64 if wide else np.int32, domain)[:m].astype(
        np.int64)
    lo = np.searchsorted(k >> shift, np.arange(num_tiles + 1), side="left")
    _at(tile_lo, np.int32, num_tiles + 1)[:] = lo
    raw = np.diff(lo)
    count = np.minimum(raw, max_per_tile)
    seg = (count + align - 1) // align * align
    drop = np.cumsum(seg) > kcap
    demand = int(seg.sum())
    count[drop], seg[drop] = 0, 0
    start = np.cumsum(seg) - seg
    used = int(seg.sum())
    _at(tile_start, np.int32, num_tiles)[:] = start
    _at(tile_count, np.int32, num_tiles)[:] = count
    st = _at(stats, np.int64, 4)
    st[3] = used
    slot = np.arange(kcap)
    owner = np.searchsorted(start, slot, side="right") - 1
    src = slot + (lo[:-1] - start)[owner]
    ok = (slot < used) & (src < (lo[:-1] + count)[owner])
    e = np.where(ok, _at(sorted_eid, np.int32, domain)[np.where(ok, src, 0)],
                 domain)
    _at(valid, np.bool_, kcap)[:] = ok
    _at(eid, np.int32, kcap)[:] = e
    _at(gid, np.int32, kcap)[:] = np.where(
        ok, _at(gid_of, np.int32, domain)[np.where(ok, e, 0)], n)
    _at(monitors, np.int32, 5)[:] = [
        st[0], raw.max(), demand, st[2] + st[1] - count.sum(),
        st[0] - st[1] - st[2]]


@pytest.mark.parametrize("pack,cull,expand,caps", [
    (False, True, "scatter", {}),
    (True, False, "scatter", dict(capacity=3000, packed_capacity=4096)),
    (False, True, "scatter", dict(max_per_tile=40, align=128)),
    (True, True, "dense", dict(packed_capacity=2048)),
], ids=["exact-cull", "packed-truncated", "capped-tiles", "dense-drops"])
def test_the_route_through_host_stand_ins(host_expand, monkeypatch, pack,
                                          cull, expand, caps):
    """``bin_gaussians``' card route on CPU tensors, its C entry run by the
    host expansion, a stable sort and the plain ranges: every field equals
    the plain version's, through truncation, max_per_tile and whole-tile
    drops, and the counter moves once."""
    def launch(name, argtypes, device, *a, stream=None, library=None):
        assert (name, library) == ("binning", None)
        assert len(a) == len(argtypes) - 1
        assert all(isinstance(v, int) or v is None for v in a)
        (*ins, n, tx, ty, bx, by, w, h, capacity, dense, dense_cap, cull,
         wide, shift, bits, kcap, max_per_tile, align, domain, per_block,
         tile, parts, stats, live, ka, kb, va, vb, counts, totals, gid_of,
         tile_lo, gcount, gstart, tile_start, tile_count, gid, valid, eid,
         monitors) = a
        assert (per_block, tile) == (binning._GAUSSIANS_PER_BLOCK,
                                     binning._SORT_TILE)
        host_expand(*ins, n, tx, bx, by, w, h, capacity, dense, dense_cap,
                    cull, wide, shift, stats, live, ka, gid_of, gcount,
                    gstart)
        keys, sorted_eid = _sort_on_host(ka, kb, va, vb, live, domain, bits,
                                         wide)
        _pack_on_host(keys, wide, shift, sorted_eid, gid_of, live, domain,
                      tx * ty, kcap, max_per_tile, align, n, stats, tile_lo,
                      tile_start, tile_count, gid, valid, eid, monitors)

    monkeypatch.setattr(_build, "launch", launch)
    pre = _pre(seed=11)
    before = binning.launches
    got = binning._bin_on_card(pre, *_args(pack, cull, expand, caps))
    assert binning.launches == before + 1
    want = binning.bin_gaussians_reference(pre, **_kw(pack, cull, expand,
                                                      **caps))
    _equal(got, want)
    if caps:
        assert int(want.dropped) > 0
