"""The preprocess route on the CPU, and the preprocess kernels' arithmetic
built for the host.

``preprocess_gaussians`` runs its two CUDA kernels only for CUDA tensors
without a precomputed covariance (precomputed colours take the kernels'
colour variant); here, on the CPU, it must be its plain version bit for
bit, with the launch counters left at 0. The kernels' per-Gaussian functions
(``forward_row``, ``backward_row`` of ``csrc/preprocess_common.cuh``) are
plain C++ under a few definitions (``tests/preprocess_host``): built with
g++ (``-ffp-contract=off``, as nvcc's ``--fmad=false``) they run here
against the plain version and autograd through it, at the card tests'
tolerances (``tests/test_torch_preprocess_cuda.py``). No JAX here.
"""

import copy
import ctypes
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import transforms

import preprocess_cases as cases
from preprocess_cases import run_pass as run

torch.set_num_threads(2)

N = 3000
W, H = 160, 120
HOST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "preprocess_host")
PASSES = [(tight, offset) for tight in (False, True)
          for offset in (False, True)]
PASS_IDS = [f"{'tight' if t else 'square'}-{'offset' if o else 'plain'}"
            for t, o in PASSES]


def _case(deg=3, seed=2):
    cam = cases.camera(W, H, "cpu")
    return cam, cases.make_case(N, deg, seed, cam)


def _equal(got: pp.Preprocessed, want: pp.Preprocessed):
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("tight,offset", PASSES, ids=PASS_IDS)
def test_cpu_tensors_take_the_plain_version(tight, offset):
    cam, case = _case()
    counts = pp.launches, pp.bwd_launches
    names = ("means3d", "scales", "rotations", "shs", "offset")
    grads = []
    for fn in (pp.preprocess_gaussians, pp.preprocess_gaussians_reference):
        leaves = {k: case[k].clone().requires_grad_() for k in names}
        pre = run(fn, case, cam, 16, tight, offset, leaves)
        grads.append((pre, torch.autograd.grad(
            [pre.means2d, pre.conic, pre.rgb],
            [leaves[k] for k in names[:4]], cases.upstream(pre.radii, 1))))
    (got, g_got), (want, g_want) = grads
    _equal(got, want)
    for a, b in zip(g_got, g_want):
        assert torch.equal(a, b)
    assert (pp.launches, pp.bwd_launches) == counts


def _at(t: torch.Tensor, shift: int) -> torch.Tensor:
    """``t``'s values in a fresh buffer, ``shift`` floats past its start
    (the data pointer's alignment moved)."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    out = buf[shift:shift + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_the_plain_version_repeats_bit_for_bit(threads):
    """700 calls of the plain version on the CPU, as
    ``test_cpu_tensors_take_the_plain_version[square-plain]`` makes them
    (the one that once saw two calls' radii differ), with the means',
    scales' and rotations' buffers shifted by 0-7 floats in turn and
    ``threads`` intra-op threads: every output equals the first call's
    bit for bit."""
    cam, case = _case()
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        with torch.no_grad():
            first = run(pp.preprocess_gaussians_reference, case, cam, 16,
                        False, False)
            for i in range(700):
                moved = {k: _at(case[k], i % 8)
                         for k in ("means3d", "scales", "rotations")}
                _equal(run(pp.preprocess_gaussians_reference, case, cam,
                           16, False, False, moved), first)
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("precomputed", ["cov3d", "colors", "both"])
def test_precomputed_inputs_take_the_plain_version(precomputed):
    cam, case = _case(deg=1)
    n = case["means3d"].shape[0]
    extra = {}
    if precomputed in ("cov3d", "both"):
        extra["cov3d_precomp"] = transforms.strip_symmetric(
            transforms.build_covariance_3d(case["scales"], 1.0,
                                           case["rotations"]))
    if precomputed in ("colors", "both"):
        extra["colors_precomp"] = torch.from_numpy(
            np.random.default_rng(0).random((n, 3)).astype(np.float32))
    counts = pp.launches, pp.bwd_launches
    args = (case["means3d"], case["scales"], case["rotations"],
            case["opacities"], case["shs"], 1, cam, 16, 16)
    got = pp.preprocess_gaussians(*args, tight=True, **extra)
    want = pp.preprocess_gaussians_reference(*args, tight=True, **extra)
    _equal(got, want)
    assert (pp.launches, pp.bwd_launches) == counts
    # on a CUDA device precomputed colours alone take the kernels (their
    # colour variant); a precomputed covariance keeps the plain version
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    assert pp.takes_kernels(on_card, **extra) == (precomputed == "colors")


def test_cuda_tensors_take_the_kernels():
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert pp.takes_kernels(on_card)
    assert not pp.takes_kernels(torch.zeros(3))
    assert not pp.takes_kernels(torch.zeros(3, device="meta"))


def test_the_offset_shifts_the_centres_after_the_rects():
    """The plain version shifts means2d by offset * (W/2, H/2) after it
    took the rects from the unshifted centres, as ``rasterize`` did; the
    offset's gradient is the centres' times (W/2, H/2)."""
    cam, case = _case(deg=0)
    off = case["offset"].clone().requires_grad_()
    plain = run(pp.preprocess_gaussians, case, cam, 16, True, False)
    pre = run(pp.preprocess_gaussians, case, cam, 16, True, True,
              {"offset": off})
    shift = torch.stack([case["offset"][:, 0] * (W * 0.5),
                         case["offset"][:, 1] * (H * 0.5)], -1)
    assert torch.equal(pre.means2d, plain.means2d + shift)
    for name in ("radii", "rect_min", "rect_max", "tiles_touched", "conic",
                 "rgb", "depths"):
        assert torch.equal(getattr(pre, name), getattr(plain, name)), name
    g = torch.randn(pre.means2d.shape, generator=torch.Generator()
                    .manual_seed(0))
    (g_off,) = torch.autograd.grad(pre.means2d, off, g)
    assert torch.equal(g_off, torch.stack([g[:, 0] * (W * 0.5),
                                           g[:, 1] * (H * 0.5)], -1))


def test_the_kernels_are_part_of_the_build():
    for name in ("preprocess_fwd", "preprocess_bwd"):
        src, lib = _build._target(name)
        assert os.path.exists(src)
        assert os.path.dirname(lib) == _build.BUILD_DIR
    header = os.path.join(_build.CSRC, "preprocess_common.cuh")
    assert os.path.exists(header)


# --- the kernels' row functions, built for the host --------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@pytest.fixture(scope="module")
def host_rows(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' row "
                    "functions")
    lib = str(tmp_path_factory.mktemp("preprocess_host") / "librows.so")
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-Wno-unknown-pragmas", "-I", HOST, "-I",
                    _build.CSRC, "-o", lib, os.path.join(HOST, "rows.cpp")],
                   check=True, capture_output=True, text=True, timeout=300)
    rows = ctypes.CDLL(lib)
    rows.host_fwd.argtypes = [_I, _LL, _P, _P] + [_P] * 5 + [_LL, _P, _P] \
        + [_P] * 8
    rows.host_bwd.argtypes = [_I, _LL, _P, _P] + [_P] * 4 + [_LL] \
        + [_P] * 9
    return rows


def _ptr(t):
    return None if t is None else t.data_ptr()


def _settings(cam, n, block, tight):
    f = torch.tensor([cam.width / (2.0 * cam.tan_fovx),
                      cam.height / (2.0 * cam.tan_fovy), cam.limit_x,
                      cam.limit_y, 1.0], dtype=torch.float32)
    i = torch.tensor([cam.width, cam.height, -(-cam.width // block),
                      -(-cam.height // block), block, block, int(tight)],
                     dtype=torch.int32)
    camera = torch.cat([cam.view.reshape(-1), cam.full_proj.reshape(-1),
                        cam.campos]).contiguous()
    return f, i, camera


def host_forward(rows, case, cam, block, tight, offset):
    """The forward kernel's arithmetic on ``case``, as a Preprocessed."""
    n = case["means3d"].shape[0]
    shs = case["shs"].reshape(n, -1).contiguous()
    f, i, camera = _settings(cam, n, block, tight)
    out = pp.Preprocessed(
        means2d=torch.empty(n, 2), depths=torch.empty(n),
        radii=torch.empty(n, dtype=torch.int32), conic=torch.empty(n, 3),
        opacity=case["opacities"], rgb=torch.empty(n, 3),
        rect_min=torch.empty(n, 2, dtype=torch.int32),
        rect_max=torch.empty(n, 2, dtype=torch.int32),
        tiles_touched=torch.empty(n, dtype=torch.int32))
    rows.host_fwd(case["deg"], n, _ptr(f), _ptr(i), _ptr(case["means3d"]),
                  _ptr(case["scales"]), _ptr(case["rotations"]),
                  _ptr(case["opacities"]), _ptr(shs), shs.shape[1],
                  _ptr(camera), _ptr(case["offset"] if offset else None),
                  *(_ptr(getattr(out, k)) for k in (
                      "means2d", "depths", "radii", "conic", "rgb",
                      "rect_min", "rect_max", "tiles_touched")))
    return out


def host_backward(rows, case, cam, cot):
    """The backward kernel's arithmetic: the gradients of the means,
    scales, rotations, SH rows (in ``shs``' shape) and offset."""
    n = case["means3d"].shape[0]
    shs = case["shs"].reshape(n, -1).contiguous()
    f, i, camera = _settings(cam, n, 16, False)
    grads = [torch.empty(n, 3), torch.empty(n, 3), torch.empty(n, 4),
             torch.empty_like(shs), torch.empty(n, 2)]
    rows.host_bwd(case["deg"], n, _ptr(f), _ptr(i), _ptr(case["means3d"]),
                  _ptr(case["scales"]), _ptr(case["rotations"]), _ptr(shs),
                  shs.shape[1], _ptr(camera),
                  *(_ptr(c.contiguous()) for c in cot),
                  *(_ptr(g) for g in grads))
    grads[3] = grads[3].reshape(case["shs"].shape)
    return grads


@pytest.mark.parametrize("deg", range(4))
@pytest.mark.parametrize("tight,offset", PASSES, ids=PASS_IDS)
def test_the_forward_kernels_arithmetic_matches_the_plain_version(
        host_rows, deg, tight, offset):
    cam, case = _case(deg, seed=deg + 10)
    got = host_forward(host_rows, case, cam, 16, tight, offset)
    want = run(pp.preprocess_gaussians_reference, case, cam, 16, tight,
               offset)
    ref = run(pp.preprocess_gaussians_reference, case, cam, 16, tight,
              offset, dtype=torch.float64)
    for name in ("means2d", "depths", "conic", "rgb"):
        r = getattr(ref, name)
        cases.assert_held(name, getattr(got, name), getattr(want, name), r,
                          case["groups"], cases.row_scale(name, r, cam))
    near = cases.boundary_rows(*cases.rounding_floats(case, cam, 16, 16,
                                                       tight))
    differ = torch.zeros(want.radii.shape[0], dtype=torch.bool)
    for name in ("radii", "rect_min", "rect_max", "tiles_touched"):
        differ |= (getattr(got, name) != getattr(want, name)).reshape(
            differ.shape[0], -1).any(dim=1)
    assert not (differ & ~near).any()
    assert int(differ.sum()) <= 1e-5 * differ.shape[0]


@pytest.mark.parametrize("deg", range(4))
def test_the_backward_kernels_arithmetic_matches_autograd(host_rows, deg):
    cam, case = _case(deg, seed=deg + 20)
    names = ("means3d", "scales", "rotations", "shs", "offset")
    radii = run(pp.preprocess_gaussians_reference, case, cam, 16, False,
                False).radii
    cot = cases.upstream(radii, seed=deg)
    got = host_backward(host_rows, case, cam, cot)
    grads = []
    for dtype in (torch.float32, torch.float64):
        leaves = {k: case[k].to(dtype, copy=True).requires_grad_()
                  for k in names}
        pre = run(pp.preprocess_gaussians_reference, case, cam, 16, False,
                  True, leaves, dtype)
        grads.append(torch.autograd.grad(
            [pre.means2d, pre.conic, pre.rgb], [leaves[k] for k in names],
            [c.to(dtype) for c in cot]))
    for name, g, w, r in zip(names, got, *grads):
        assert g.shape == w.shape, name
        cases.assert_held(name, g, w, r, case["groups"])


def _floats_at(address: int, count: int) -> torch.Tensor:
    return torch.tensor(list((ctypes.c_float * count).from_address(address)),
                        dtype=torch.float32)


def host_launch(rows):
    """A stand-in for ``_build.launch`` that runs the preprocess kernels'
    C entries on the host rows: the same arguments, CPU pointers."""
    def launch(name, argtypes, device, *a, stream=None):
        if name == "preprocess_fwd":
            (means, scales, rots, opac, shs, stride, deg, view, proj, campos,
             off, n, fx, fy, lx, ly, w, h, tx, ty, bx, by, sm, tight,
             *outs) = a
            i = torch.tensor([w, h, tx, ty, bx, by, tight],
                             dtype=torch.int32)
        else:
            (means, scales, rots, shs, stride, deg, view, proj, campos, n,
             fx, fy, lx, ly, w, h, sm, *grads) = a
            i = torch.tensor([w, h, 1, 1, 1, 1, 0], dtype=torch.int32)
        assert len(a) == len(argtypes) - 1
        f = torch.tensor([fx, fy, lx, ly, sm], dtype=torch.float32)
        camera = torch.cat([_floats_at(view, 16), _floats_at(proj, 16),
                            _floats_at(campos, 3)])
        if name == "preprocess_fwd":
            rows.host_fwd(deg, n, _ptr(f), _ptr(i), means, scales, rots,
                          opac, shs, stride, _ptr(camera), off, *outs)
        else:
            rows.host_bwd(deg, n, _ptr(f), _ptr(i), means, scales, rots, shs,
                          stride, _ptr(camera), *grads)
    return launch


@pytest.mark.parametrize("deg,tight,offset", [(0, False, True),
                                              (2, True, False),
                                              (3, True, True)])
def test_the_kernel_route_through_the_host_rows(host_rows, monkeypatch, deg,
                                                tight, offset):
    """The kernels' route end to end on the CPU: ``_Preprocess`` and its
    calls, with the C entries run by the host rows, against the plain
    version and autograd through it; each counter moves once."""
    monkeypatch.setattr(pp, "takes_kernels", lambda *a, **k: True)
    monkeypatch.setattr(_build, "launch", host_launch(host_rows))
    cam, case = _case(deg, seed=deg + 30)
    names = ("means3d", "scales", "rotations", "shs", "offset")
    radii = run(pp.preprocess_gaussians_reference, case, cam, 16, tight,
                offset).radii
    cot = cases.upstream(radii, seed=deg)
    outs = []
    for fn, dtype in ((pp.preprocess_gaussians, torch.float32),
                      (pp.preprocess_gaussians_reference, torch.float32),
                      (pp.preprocess_gaussians_reference, torch.float64)):
        leaves = {k: case[k].to(dtype, copy=True).requires_grad_()
                  for k in names}
        counts = pp.launches, pp.bwd_launches
        pre = run(fn, case, cam, 16, tight, offset, leaves, dtype)
        want = [leaves[k] for k in names[:4]] + (
            [leaves["offset"]] if offset else [])
        grads = torch.autograd.grad([pre.means2d, pre.conic, pre.rgb], want,
                                    [c.to(dtype) for c in cot])
        moved = (pp.launches - counts[0], pp.bwd_launches - counts[1])
        assert moved == ((1, 1) if fn is pp.preprocess_gaussians
                         else (0, 0))
        outs.append((pre, grads))
    (got, g_got), (plain, g_plain), (ref, g_ref) = outs
    assert got.opacity is case["opacities"]
    for name in ("means2d", "depths", "conic", "rgb"):
        r = getattr(ref, name)
        cases.assert_held(name, getattr(got, name), getattr(plain, name), r,
                          case["groups"], cases.row_scale(name, r, cam))
    for name in ("radii", "rect_min", "rect_max", "tiles_touched"):
        assert getattr(got, name).dtype == torch.int32
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    for name, g, p, r in zip(names, g_got, g_plain, g_ref):
        assert g.shape == p.shape, name
        cases.assert_held(name, g, p, r, case["groups"])


# MKL picks its code path from the CPU it finds, and its paths round a
# float32 matrix product differently: its SSE path has no fused multiply-adds.
# The host rows repeat the fused order that MKL's AVX2 path shares, and the
# colour variant's case has a row within 1e-5 of a rounding boundary of the
# plain version's ``points @ view.T``, so its integer fields follow the path.
# MKL reads MKL_CBWR once, when it loads, so the cases run in a child process
# that pins the AVX2 path, unless this process already has it pinned.
_MKL_PATH = "AVX2"


@pytest.fixture(scope="module")
def colour_variant_child(request):
    """The colour variant's cases run by pytest in a child process under
    MKL_CBWR=AVX2: its report, or None when this process has that pin."""
    if os.environ.get("MKL_CBWR") == _MKL_PATH:
        return None
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env["MKL_CBWR"] = _MKL_PATH
    test = f"{os.path.abspath(__file__)}::" \
        "test_the_colour_variant_through_the_host_rows"
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", test, "-q", "-rA",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist"],
        env=env, cwd=str(request.config.rootpath), capture_output=True,
        text=True, timeout=600)
    return proc.stdout + proc.stderr


@pytest.mark.parametrize("tight,offset", [(False, False), (True, True)],
                         ids=["square-plain", "tight-offset"])
def test_the_colour_variant_through_the_host_rows(
        request, colour_variant_child, tight, offset):
    """Precomputed colours through the kernels' route, the C entries run by
    the host rows at the colour variant's degree: the colours are the rgb
    output itself and take the upstream rgb gradient as it is; the other
    fields and gradients are held to the plain version given the same
    colours, as the SH route's are; each counter moves once. Runs under
    MKL's AVX2 path (see ``colour_variant_child``)."""
    if colour_variant_child is None:
        _colour_variant(request.getfixturevalue("host_rows"),
                        request.getfixturevalue("monkeypatch"), tight,
                        offset)
        return
    case = request.node.name[request.node.name.index("["):]
    assert any(line.startswith("PASSED ") and line.endswith(case)
               for line in colour_variant_child.splitlines()), \
        colour_variant_child[-6000:]


def _colour_variant(host_rows, monkeypatch, tight, offset):
    monkeypatch.setattr(pp, "takes_kernels", lambda *a, **k: True)
    monkeypatch.setattr(_build, "launch", host_launch(host_rows))
    cam, case = _case(3, seed=40)
    n = case["means3d"].shape[0]
    colors = torch.from_numpy(np.random.default_rng(3).random(
        (n, 3)).astype(np.float32))
    names = ("means3d", "scales", "rotations", "offset")
    radii = run(pp.preprocess_gaussians_reference, case, cam, 16, tight,
                offset).radii
    cot = cases.upstream(radii, seed=5)
    outs = []
    for fn, dtype in ((pp.preprocess_gaussians, torch.float32),
                      (pp.preprocess_gaussians_reference, torch.float32),
                      (pp.preprocess_gaussians_reference, torch.float64)):
        leaves = {k: case[k].to(dtype, copy=True).requires_grad_()
                  for k in names}
        col = colors.to(dtype, copy=True).requires_grad_()
        c = {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                 else v) for k, v in case.items()} | leaves
        cam_d = cam
        if dtype != torch.float32:
            cam_d = copy.copy(cam)
            for k in ("view", "full_proj", "campos"):
                setattr(cam_d, k, getattr(cam, k).to(dtype))
        counts = pp.launches, pp.bwd_launches
        pre = fn(c["means3d"], c["scales"], c["rotations"], c["opacities"],
                 c["shs"], 3, cam_d, 16, 16, tight=tight,
                 colors_precomp=col,
                 means2d_offset=c["offset"] if offset else None)
        want = [leaves[k] for k in names[:3]] + [col] + (
            [leaves["offset"]] if offset else [])
        grads = torch.autograd.grad([pre.means2d, pre.conic, pre.rgb], want,
                                    [x.to(dtype) for x in cot])
        moved = (pp.launches - counts[0], pp.bwd_launches - counts[1])
        assert moved == ((1, 1) if fn is pp.preprocess_gaussians
                         else (0, 0))
        outs.append((pre, col, grads))
    (got, col, g_got), (plain, _, g_plain), (ref, _, g_ref) = outs
    assert got.rgb is col and got.opacity is case["opacities"]
    assert torch.equal(g_got[3], cot[2])
    for name in ("means2d", "depths", "conic"):
        r = getattr(ref, name)
        cases.assert_held(name, getattr(got, name), getattr(plain, name), r,
                          case["groups"], cases.row_scale(name, r, cam))
    for name in ("radii", "rect_min", "rect_max", "tiles_touched"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    held = ("means3d", "scales", "rotations") + (("offset",) if offset
                                                  else ())
    for name, g, p, r in zip(held, g_got[:3] + g_got[4:],
                             g_plain[:3] + g_plain[4:],
                             g_ref[:3] + g_ref[4:]):
        assert g.shape == p.shape, name
        cases.assert_held(name, g, p, r, case["groups"])


@pytest.mark.parametrize("flat", [False, True])
def test_appended_edge_rows_keep_the_inputs_layout(flat):
    cam = cases.camera(64, 48, "cpu")
    case = cases.make_case(40, 3, 8, cam)
    inputs = {k: case[k][:40] for k in ("means3d", "scales", "rotations",
                                         "opacities", "offset", "shs")}
    if flat:  # the (N, 3K) rows models.gaussians.get_features gives
        inputs["shs"] = inputs["shs"].reshape(40, -1)
    out, groups = cases.append_edges(inputs, cam)
    assert groups == case["groups"]
    for k, v in out.items():
        assert v.shape[1:] == inputs[k].shape[1:] and v.dtype == torch.float32
        assert torch.equal(v[:40], inputs[k]), k
    for k in ("means3d", "scales", "rotations", "opacities"):
        assert torch.equal(out[k], case[k]), k


def test_magnitude_bands_set_the_largest_rows_apart():
    """The largest 0.1 % of the bulk's live rows form their own band (here
    one of 998: an outlier), zero and non-finite rows theirs, and edge
    rows keep their group."""
    groups = ["bulk"] * 1000 + ["degenerate"] * 2
    ref = torch.ones((1002, 3), dtype=torch.float64)
    ref[:1000, 0] = torch.linspace(1e-3, 1.0, 1000, dtype=torch.float64)
    ref[:1000, 1:] = 0.0
    ref[7, 0], ref[8] = 2.5e6, 0.0
    ref[9] = float("nan")
    bands = cases.magnitude_bands(groups, ref)
    assert bands[7] == "bulk top" and bands[999] == "bulk body"
    assert bands[8] == "bulk 0" and bands[9] == "bulk -"
    assert bands[1000:] == ["degenerate"] * 2
    assert bands.count("bulk top") == 1
    assert bands.count("bulk body") == 997
