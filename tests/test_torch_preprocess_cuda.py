"""The preprocess kernels (``csrc/preprocess_{fwd,bwd}.cu``) on the card,
against the plain version (``preprocess_gaussians_reference``) and autograd
through it.

This file imports no JAX, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_preprocess_cuda.py

Every case holds ``preprocess_cases.make_case``'s bulk and its edge rows
(dead slots, Gaussians behind the camera and inside the near plane, the
frustum clamp active, near-degenerate scales and quaternions).

Tolerances. The kernels repeat the tensor code's operation order (its
matrix products as cuBLAS sums them), but reductions over a row and
autograd's sums run in orders of their own. Where a Gaussian is much
longer than it is wide, its conic and its scale gradient turn rounding in
the rotation into errors of ~1e-4 of the row's scale, in the plain
version itself: its CPU and card runs differ by as much on the H100. So
each float field and each gradient is held to the plain version run in
float64, and its error there must stay within 1e-5 of the scale or within
twice the float32 plain version's own, whichever is larger: as accurate
as the plain version. Errors are read per group of rows (the bulk, each
kind of edge row), against each row's scale for the forward (the frame's
size for means2d, one world unit for depths, the row's larger diagonal
term for the conic, 1 for colours) and the group's largest |gradient| for
the backward (the bulk's rows lie in front of the camera, so no few rows
set its scale). The depths are the plain version's bits, as binning sorts
by them. Integer outputs are equal, except on rows
whose plain-version value before floor or ceil lies within 1e-5 of an
integer (or its depth that close to the 0.2 near plane): the test prints
how many rows differ and how many lie that close, and the rows that differ
stay under 1e-5 of the rows.
"""

import json
import os

import pytest
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.train import loop
from neuralgaussiansplatting_torch.train import optim

import preprocess_cases as cases
from preprocess_cases import run_pass as run

N = 200_000
W, H = 640, 480
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(deg, tight, offset, False) for deg in range(4)
         for tight in (False, True) for offset in (False, True)]
CASES += [(3, True, True, True), (1, False, False, True)]
IDS = [f"deg{d}-{'tight' if t else 'square'}-{'offset' if o else 'plain'}"
       f"{'-strip' if s else ''}" for d, t, o, s in CASES]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on an NVIDIA GPU")


def _case(deg, strip, seed=5, block=16):
    cam = cases.camera(W, H // 4 if strip else H, "cuda", strip=strip)
    case = cases.make_case(N, deg, seed, cam, device="cuda")
    return cam, case, block


@pytest.mark.cuda
@pytest.mark.parametrize("deg,tight,offset,strip", CASES, ids=IDS)
def test_preprocess_forward_matches_plain_version(deg, tight, offset,
                                                  strip):
    _need_gpu()
    cam, case, block = _case(deg, strip)
    got = run(pp.preprocess_gaussians, case, cam, block, tight, offset)
    want = run(pp.preprocess_gaussians_reference, case, cam, block, tight,
                offset)
    ref = run(pp.preprocess_gaussians_reference, case, cam, block, tight,
               offset, dtype=torch.float64)
    torch.cuda.synchronize()
    assert got.opacity is case["opacities"]
    assert torch.equal(got.depths, want.depths), (
        "the depths are not the plain version's bits: binning sorts by "
        "them, so two overlapping Gaussians an ulp apart would blend in the "
        "other order; the kernels' view transform (affine_row) no longer "
        "sums as cuBLAS does here")
    n = want.radii.shape[0]
    for name in ("means2d", "depths", "conic", "rgb"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        r = getattr(ref, name)
        cases.assert_held(name, g, w, r, case["groups"],
                          cases.row_scale(name, r, cam))
    near = cases.boundary_rows(*cases.rounding_floats(case, cam, block,
                                                       block, tight))
    differ = torch.zeros(n, dtype=torch.bool, device="cuda")
    for name in ("radii", "rect_min", "rect_max", "tiles_touched"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype == torch.int32 and g.shape == w.shape
        differ |= (g != w).reshape(n, -1).any(dim=1)
    print(f"{int(differ.sum())} of {n} rows differ in an integer output; "
          f"{int(near.sum())} lie within 1e-5 of a rounding boundary")
    assert not (differ & ~near).any()
    assert int(differ.sum()) <= 1e-5 * n
    # the edge rows are culled where the plain version culls them
    groups = case["groups"]
    for i, name in enumerate(groups[N:], start=N):
        if name in ("dead", "behind", "near"):
            assert int(got.radii[i]) == 0 == int(want.radii[i]), (i, name)


@pytest.mark.cuda
@pytest.mark.parametrize("deg,tight,offset,strip", CASES, ids=IDS)
def test_preprocess_backward_matches_autograd(deg, tight, offset, strip):
    _need_gpu()
    cam, case, block = _case(deg, strip)
    names = ("means3d", "scales", "rotations", "shs", "offset")
    with torch.no_grad():
        radii = run(pp.preprocess_gaussians_reference, case, cam, block,
                     tight, offset).radii
    cot = cases.upstream(radii, seed=deg)
    grads = []
    for fn, dtype in ((pp.preprocess_gaussians, torch.float32),
                      (pp.preprocess_gaussians_reference, torch.float32),
                      (pp.preprocess_gaussians_reference, torch.float64)):
        leaves = {k: case[k].to(dtype, copy=True).requires_grad_()
                  for k in names}
        pre = run(fn, case, cam, block, tight, offset, leaves, dtype)
        want = [leaves[k] for k in names[:4]] + (
            [leaves["offset"]] if offset else [])
        grads.append(torch.autograd.grad(
            [pre.means2d, pre.conic, pre.rgb], want,
            [c.to(dtype) for c in cot]))
    for name, g, w, r in zip(names, *grads):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        cases.assert_held(name, g, w, r, case["groups"])


@pytest.mark.cuda
def test_preprocess_backward_repeats_bit_for_bit():
    _need_gpu()
    cam, case, block = _case(3, False)
    names = ("means3d", "scales", "rotations", "shs", "offset")
    with torch.no_grad():
        radii = pp.preprocess_gaussians(
            case["means3d"], case["scales"], case["rotations"],
            case["opacities"], case["shs"], 3, cam, block, block).radii
    cot = cases.upstream(radii, seed=11)
    runs = []
    for _ in range(2):
        leaves = {k: case[k].clone().requires_grad_() for k in names}
        pre = run(pp.preprocess_gaussians, case, cam, block, True, True,
                   leaves)
        runs.append(torch.autograd.grad([pre.means2d, pre.conic, pre.rgb],
                                        [leaves[k] for k in names], cot))
    for name, a, b in zip(names, *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_preprocess_counters_move_once_a_call():
    _need_gpu()
    cam, case, block = _case(2, False)
    leaves = {k: case[k].clone().requires_grad_()
              for k in ("means3d", "scales", "rotations", "shs", "offset")}
    f0, b0 = pp.launches, pp.bwd_launches
    with torch.no_grad():
        run(pp.preprocess_gaussians, case, cam, block, False, False)
    assert (pp.launches - f0, pp.bwd_launches - b0) == (1, 0)
    pre = run(pp.preprocess_gaussians, case, cam, block, True, True, leaves)
    assert (pp.launches - f0, pp.bwd_launches - b0) == (2, 0)
    (pre.means2d.sum() + pre.conic.sum() + pre.rgb.sum()).backward()
    assert (pp.launches - f0, pp.bwd_launches - b0) == (2, 1)
    run(pp.preprocess_gaussians_reference, case, cam, block, False, False)
    assert (pp.launches - f0, pp.bwd_launches - b0) == (2, 1)


def _norms(tree) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


@pytest.mark.cuda
def test_train_step_with_the_kernels_matches_the_plain_version(monkeypatch):
    """One ``train_step`` on the seq route with the kernels against the
    same step through the plain version, held to the benchmark's
    ``correct`` limits for training (``ngsbench/limits``): the loss, the
    gradient as Adam took it and the parameters' change, per leaf."""
    _need_gpu()
    from ngsbench import check
    settings = rast.make_settings("seq", capacity=1 << 20,
                                  max_per_tile=4096, fast_sort=True,
                                  tight_culling=True)
    params, state, cam = demo.demo_scene(n=50_000, w=512, h=512,
                                         sh_degree=3)
    with torch.no_grad():
        gt = render(cam, params, state.alive, 3, torch.zeros(3, device="cuda"),
                    settings)["render"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = params._replace(
        opacity=params.opacity + torch.randn(params.opacity.shape,
                                             generator=gen, device="cuda"),
        xyz=params.xyz + 0.01 * torch.randn(params.xyz.shape, generator=gen,
                                            device="cuda"))
    tx = optim.make_optimizer(optim.OptimizationParams(), 1.0)
    results = {}
    for route in ("kernels", "plain"):
        if route == "plain":
            monkeypatch.setattr(pp, "takes_kernels", lambda *a, **k: False)
        ts = loop.TrainState(params, state, tx.init(params), 0)
        f0, b0 = pp.launches, pp.bwd_launches
        new, metrics = loop.train_step(ts, cam, gt,
                                       torch.zeros(3, device="cuda"), tx=tx,
                                       sh_degree=3, settings=settings,
                                       lambda_dssim=0.2)
        assert (pp.launches - f0, pp.bwd_launches - b0) == (
            (1, 1) if route == "kernels" else (0, 0))
        fields = params._fields
        grads = {f: new.opt_state[f].mu / (1.0 - 0.9) for f in fields
                 if f in new.opt_state}
        change = {f: getattr(new.params, f) - getattr(params, f)
                  for f in grads}
        results[route] = {"loss": [float(metrics["loss"])],
                          "grad_norm": _norms(grads),
                          "change_norm": _norms(change)}
    numbers = check.train_numbers(results["kernels"], results["plain"])
    with open(os.path.join(ROOT, "ngsbench", "limits",
                           "garden840.train.json")) as f:
        limits = json.load(f)
    ok, judged = check.judge(numbers, limits)
    print(judged)
    assert ok, judged
