"""Scaffold-GS in the port (``models/scaffold.py``,
``gaussian_renderer.render_scaffold``, ``train/scaffold_loop.py``) against
the benchmark's plain reference (``ngsbench/reference/scaffold.py``), and
the precomputed-colour preprocess kernels on the card.

On the CPU, at a small size (2,000 anchors, a tenth of them behind the
camera and many outside its frustum, 96 x 64, two views), the port and the
reference decode the same seeded anchors and nets: the visible anchors and
the gate equal, the kept Gaussians' attributes, the image, the loss, every
leaf's gradient (the repository's gradient gate, atol 5e-4 max|g| and rtol
5e-3) and one Adam step's change. The reference with its MLPs in bfloat16,
or with TF32's operands in their matrix products, fails those gates.

The card tests (``-m cuda``; this file imports no JAX, so on a GPU host
without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_scaffold.py``): the colour variant of the preprocess
kernels against the SH variant and the plain version, ``ScaffoldTrainer.
step`` under ``torch.cuda.set_sync_debug_mode("error")`` (no read back to
the host), and two runs of 5 steps bit for bit.
"""

import math
import types

import numpy as np
import pytest
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch import gaussian_renderer as gr
from neuralgaussiansplatting_torch.models import scaffold
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.train import scaffold_loop as sl
from neuralgaussiansplatting_torch.utils import losses

from ngsbench.reference import render as ref_render
from ngsbench.reference import scaffold as ref

import preprocess_cases as cases
from preprocess_cases import run_pass as run

torch.set_num_threads(2)

N_ANCHORS = 2000
W, H = 96, 64
VIEWS = 2
TILE = 32
RATES = {"anchor": [0.0, 0.0], "offset": [0.01, 0.0001], "anchor_feat": 0.0075,
         "scaling": 0.007, "mlp_opacity": [0.002, 0.00002],
         "mlp_cov": [0.004, 0.004], "mlp_color": [0.008, 0.00005],
         "embedding_appearance": [0.05, 0.0005], "max_steps": 30000}
FIRST = 15001


def make_scene(device="cpu", seed=3):
    """(params, nets, cams, gts): seeded anchors round the origin, a tenth
    of them behind the demo camera, small neural Gaussians; two views."""
    g = torch.Generator().manual_seed(seed)
    n = N_ANCHORS
    anchor = (torch.rand((n, 3), generator=g) * 2 - 1) * 2.2
    behind = n // 10
    anchor[:behind] = torch.tensor([0.0, 0.0, -7.0]) + 0.3 * torch.randn(
        (behind, 3), generator=g)
    spacing = 4.4 / n ** (1 / 3)
    scaling = torch.randn((n, 6), generator=g) * 0.2 + math.log(spacing)
    scaling[:, 3:] -= 2.5
    params = scaffold.ScaffoldParams(
        anchor=anchor, offset=torch.randn((n, scaffold.N_OFFSETS, 3),
                                          generator=g),
        anchor_feat=torch.randn((n, scaffold.FEAT_DIM), generator=g),
        scaling=scaling)
    nets = scaffold.init_nets(VIEWS, seed, device="cpu")
    cams = [demo.demo_camera(W, H, angle_y=0.3 * v, device=device)
            for v in range(VIEWS)]
    gts = torch.rand((VIEWS, 3, H, W), generator=g)
    move = {k: v.to(device) for k, v in params._asdict().items()}
    return (scaffold.ScaffoldParams(**move),
            {k: v.to(device) for k, v in nets.items()}, cams, gts.to(device))


def ref_camera(cam):
    """The reference's camera (``ngsbench.scene.Camera``'s fields, numpy)."""
    return types.SimpleNamespace(
        view=cam.view.cpu().numpy(), full_proj=cam.full_proj.cpu().numpy(),
        campos=cam.campos.cpu().numpy(), tan_fovx=cam.tan_fovx,
        tan_fovy=cam.tan_fovy, width=cam.width, height=cam.height)


SETTINGS = rast.make_settings("seq", capacity=1 << 16, max_per_tile=1 << 13,
                              tight_culling=True)
ROWS = N_ANCHORS  # a row for every anchor: the visible ones come first
BG = torch.zeros(3)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


ATTRS = ("xyz", "scaling", "rotation", "color", "opacity")


def port_record(params, nets, cam, view, gt) -> dict:
    """The port's view: visible anchors, gate, the kept Gaussians'
    attributes, image, loss and every leaf's gradient."""
    leaves = {k: v.clone().requires_grad_()
              for k, v in (params._asdict() | nets).items()}
    p = scaffold.ScaffoldParams(*(leaves[k] for k in
                                  scaffold.ScaffoldParams._fields))
    out = gr.render_scaffold(cam, view, p, {k: leaves[k] for k in nets}, BG,
                             SETTINGS, ROWS)
    g = out["generated"]
    loss = (losses.photometric_loss(out["render"], gt, 0.2)
            + scaffold.SCALE_REG * scaffold.scale_regulariser(g))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    # the rows back in the anchors' order, as the reference keeps them
    order = torch.argsort(out["rows"])
    k = scaffold.N_OFFSETS
    kept = g.gate.reshape(-1, k)[order].reshape(-1)

    def anchor_order(t):
        return t.reshape((-1, k) + t.shape[1:])[order].reshape(t.shape)

    return {"visible": out["visible"][order], "gate": kept,
            **{a: anchor_order(getattr(g, a))[kept].detach() for a in ATTRS},
            "image": out["render"].detach(), "loss": float(loss.detach()),
            "grads": dict(zip(leaves, grads)), "out": out}


def ref_record(params, nets, cam, view, gt, **mlp) -> dict:
    """The reference's view, as ``port_record``'s; ``mlp`` its MLPs'
    precision (``mlp_dtype``, ``mlp_tf32``)."""
    leaves = {k: v.clone().requires_grad_()
              for k, v in (params._asdict() | nets).items()}
    f = ref.forward(leaves, ref_camera(cam), view, BG,
                    n_offsets=scaffold.N_OFFSETS, tile=TILE, **mlp)
    img = f["image"].detach().requires_grad_()
    photo = ref_render.loss_fn(img, gt, 0.2)
    (gimg,) = torch.autograd.grad(photo, [img])
    gen = f["generated"]
    return {"visible": f["visible"], "gate": gen["gate"],
            **{k: gen[k].detach() for k in ATTRS}, "image": f["image"],
            "loss": float(photo.detach()) + 0.01 * float(f["reg"].detach()),
            "grads": ref.backward(f, leaves, gimg, 0.01)}


def verdicts(got: dict, want: dict) -> dict:
    """{gate: passed} of ``got`` held to ``want``: the visible anchors and
    the gate equal, the kept attributes within rtol 1e-5 / atol 1e-6, the
    image within 5e-5, the loss within 1e-5 of itself, each gradient at
    atol 5e-4 max|g| and rtol 5e-3."""
    out = {"visible": torch.equal(got["visible"], want["visible"]),
           "gate": torch.equal(got["gate"], want["gate"])}
    if out["gate"]:
        for k in ATTRS:
            out[k] = torch.allclose(got[k], want[k].float(), rtol=1e-5,
                                    atol=1e-6)
    out["image"] = bool((got["image"] - want["image"]).abs().max() < 5e-5)
    out["loss"] = abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    for k, g in got["grads"].items():
        r = want["grads"][k].float()
        out[f"grad {k}"] = torch.allclose(g.float(), r, rtol=5e-3,
                                          atol=5e-4 * float(r.abs().max()))
    return out


@pytest.mark.parametrize("view", range(VIEWS))
def test_the_port_matches_the_reference(scene, view):
    params, nets, cams, gts = scene
    got = port_record(params, nets, cams[view], view, gts[view])
    want = ref_record(params, nets, cams[view], view, gts[view])
    v = verdicts(got, want)
    assert all(v.values()), [k for k, ok in v.items() if not ok]
    # the scene exercises the prefilter and the gate on both sides
    vis = want["visible"]
    assert 0 < int(vis.sum()) < N_ANCHORS
    assert not vis[:N_ANCHORS // 10].any()
    kept = int(want["gate"].sum())
    assert 0.2 < kept / (int(vis.sum()) * scaffold.N_OFFSETS) < 0.8


def test_the_bfloat16_mlp_control_fails(scene):
    """The reference with its MLPs in bfloat16, in the port's place, fails
    at least one of the gates the port passes."""
    params, nets, cams, gts = scene
    want = ref_record(params, nets, cams[0], 0, gts[0])
    ctl = ref_record(params, nets, cams[0], 0, gts[0],
                     mlp_dtype=torch.bfloat16)
    v = verdicts(ctl, want)
    assert not all(v.values())


def test_the_tf32_mlp_control_fails(scene):
    """The reference with TF32's operands in its MLPs' matrix products (10
    mantissa bits, rounded to nearest, ties away from zero; the sums in
    float32) fails at least one of the gates the port passes."""
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -12,
                      -(1 + 2 ** -11), 3.0 * 2 ** -130, float("inf")])
    assert ref.tf32(x).tolist() == [
        1.0, 1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 ** -10), 3.0 * 2 ** -130,
        float("inf")]
    params, nets, cams, gts = scene
    want = ref_record(params, nets, cams[0], 0, gts[0])
    ctl = ref_record(params, nets, cams[0], 0, gts[0], mlp_tf32=True)
    v = verdicts(ctl, want)
    assert not all(v.values())


@pytest.mark.parametrize("layout", ["every", "visible"])
def test_one_adam_step_matches_the_reference(scene, layout):
    """``ScaffoldTrainer``'s first step from iteration 15001 against the
    reference's, with a row for every anchor ("every") or five more than
    the view's visible anchors ("visible"): the rates per group at that
    iteration, the change of every element whose gradient is not
    round-off (above 1e-3 of its leaf's largest), and the change's norm
    per leaf."""
    params, nets, cams, gts = scene
    rows = N_ANCHORS
    if layout == "visible":
        rows = 5 + int(scaffold.visible_anchors(cams[1], params, TILE,
                                                TILE).sum())
    sl.steps = 0
    tr = sl.ScaffoldTrainer(params, dict(nets), rows, SETTINGS,
                            cameras_extent=2.0, first_iteration=FIRST)
    m = tr.step(cams[1], gts[1], 1)
    assert sl.steps == 1 and tr.iteration == FIRST + 1
    assert int(m["anchor_overflow"]) == 0
    r = ref.steps(params._asdict(), nets, [ref_camera(cams[1])], [1],
                  [gts[1]], BG, n_offsets=scaffold.N_OFFSETS, tile=TILE,
                  lambda_dssim=0.2, scale_reg=0.01, rates=RATES,
                  first_iteration=FIRST, extent=2.0)
    assert abs(float(m["loss"]) - r["loss"][0]) <= 1e-5 * r["loss"][0]
    new = tr.ts.params._asdict() | tr.ts.nets
    start = params._asdict() | nets
    for k, v in new.items():
        change, want = v - start[k], r["params"][k] - start[k]
        g = r["grad"][k].abs()
        big = g > 1e-3 * float(g.max())
        assert torch.allclose(change[big], want[big], rtol=1e-4,
                              atol=1e-9), k
        assert abs(float(change.norm()) - r["change_norm"][k]) <= (
            1e-2 * r["change_norm"][k] + 1e-12), k
    assert float(new["anchor"].sub(start["anchor"]).abs().max()) == 0.0


def test_the_step_counts_and_monitors(scene):
    params, nets, cams, gts = scene
    with torch.no_grad():
        out = gr.render_scaffold(cams[0], 0, params, nets, BG, SETTINGS,
                                 ROWS)
    gen = out["generated"]
    assert gen.xyz.shape == (ROWS * scaffold.N_OFFSETS, 3)
    assert int(out["anchor_overflow"]) == 0
    assert int(out["neural_gaussians"]) == int(gen.gate.sum())
    assert int(out["visible_anchors"]) == int(out["visible"].sum())
    # a candidate that is not kept has opacity 0, and the preprocess
    # culls it
    assert float(gen.opacity[~gen.gate].abs().max()) == 0.0
    assert int(out["radii"][~gen.gate].abs().max()) == 0
    assert int(out["dropped"]) == 0


def test_compacted_anchors_render_the_same_image(scene):
    """The visible anchors gathered into just more rows than they fill
    render the image of a row for every anchor; fewer rows than visible
    anchors report the overflow."""
    params, nets, cams, gts = scene
    with torch.no_grad():
        dead = gr.render_scaffold(cams[0], 0, params, nets, BG, SETTINGS,
                                  N_ANCHORS)
        visible = int(dead["visible_anchors"])
        packed = gr.render_scaffold(cams[0], 0, params, nets, BG, SETTINGS,
                                    visible + 100)
        short = gr.render_scaffold(cams[0], 0, params, nets, BG, SETTINGS,
                                   visible - 10)
    assert int(packed["anchor_overflow"]) == 0
    assert int(packed["neural_gaussians"]) == int(dead["neural_gaussians"])
    assert float((packed["render"] - dead["render"]).abs().max()) < 1e-6
    assert int(short["anchor_overflow"]) == 10


def test_compact_keeps_the_marked_rows_in_order():
    mask = torch.tensor([0, 1, 1, 0, 1, 0, 1], dtype=torch.bool)
    idx, count = scaffold.compact(mask, 6)
    assert idx.tolist() == [1, 2, 4, 6, 0, 3] and int(count) == 4
    idx, count = scaffold.compact(mask, 3)
    assert idx.tolist() == [1, 2, 4] and int(count) == 4


def test_anchors_from_a_point_cloud():
    """Voxelised points with zero offsets and features and the log of the
    root mean squared distance to the 3 nearest anchors in all six
    scalings, as the original's ``create_from_pcd``."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (500, 3))
    pts = np.concatenate([pts, pts[:50]])   # 50 voxels twice
    p = scaffold.init_anchors(pts, voxel_size=0.001, device="cpu")
    assert p.anchor.shape == (500, 3)
    assert p.offset.shape == (500, scaffold.N_OFFSETS, 3)
    assert float(p.offset.abs().max()) == 0.0 == float(
        p.anchor_feat.abs().max())
    assert torch.equal(p.scaling[:, :1].expand(-1, 6), p.scaling)
    d = torch.cdist(p.anchor.double(), p.anchor.double())
    d.fill_diagonal_(float("inf"))
    near = d.topk(3, largest=False).values.pow(2).mean(1)
    assert torch.allclose(p.scaling[:, 0].double(),
                          near.clamp_min(1e-7).sqrt().log(), atol=1e-4)


def test_the_rates_follow_the_schedules():
    opt = sl.ScaffoldOptimizationParams()
    tx = sl.make_optimizer(opt, 3.0, VIEWS, first_iteration=FIRST)
    for name, lr in tx.lrs.items():
        got = lr(4) if callable(lr) else lr
        want = ref.rate(RATES, name, FIRST + 4, 3.0)
        assert math.isclose(got, want, rel_tol=1e-6, abs_tol=0.0), name
    assert tx.lrs["anchor"](0) == 0.0
    assert len(tx.lrs) == 4 + 13


# --- on the card -------------------------------------------------------------


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("tight,offset", [(False, False), (True, True)],
                         ids=["square-plain", "tight-offset"])
def test_colour_kernels_match_the_sh_kernels_and_the_plain_version(
        tight, offset):
    """The colour variant's forward is the SH variant's, bit for bit, in
    every field but the colour, which is the input tensor itself; its
    gradients are held to the plain version as the SH pair's are
    (``tests/test_torch_preprocess_cuda.py``), the colours' being the
    upstream gradient; one launch each way."""
    _need_gpu()
    cam = cases.camera(640, 480, "cuda")
    case = cases.make_case(200_000, 3, 9, cam, device="cuda")
    n = case["means3d"].shape[0]
    colors = torch.rand((n, 3), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
    sh = run(pp.preprocess_gaussians, case, cam, 16, tight, offset)
    names = ("means3d", "scales", "rotations", "offset")
    cot = cases.upstream(sh.radii, seed=4)
    outs = []
    for fn, dtype in ((pp.preprocess_gaussians, torch.float32),
                      (pp.preprocess_gaussians_reference, torch.float32),
                      (pp.preprocess_gaussians_reference, torch.float64)):
        c = {k: (v.to(dtype, copy=True).requires_grad_()
                 if k in names else
                 (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                  else v)) for k, v in case.items()}
        col = colors.to(dtype, copy=True).requires_grad_()
        cam_d = cam
        if dtype != torch.float32:
            cam_d = types.SimpleNamespace(**vars(cam))
            for k in ("view", "full_proj", "campos"):
                setattr(cam_d, k, getattr(cam, k).to(dtype))
        f0, b0 = pp.launches, pp.bwd_launches
        pre = fn(c["means3d"], c["scales"], c["rotations"], c["opacities"],
                 c["shs"], 3, cam_d, 16, 16, tight=tight,
                 colors_precomp=col,
                 means2d_offset=c["offset"] if offset else None)
        want = [c[k] for k in names[:3]] + [col] + (
            [c["offset"]] if offset else [])
        grads = torch.autograd.grad([pre.means2d, pre.conic, pre.rgb], want,
                                    [x.to(dtype) for x in cot])
        assert (pp.launches - f0, pp.bwd_launches - b0) == (
            (1, 1) if fn is pp.preprocess_gaussians else (0, 0))
        outs.append((pre, col, grads))
    (got, col, g_got), (plain, _, g_plain), (ref64, _, g_ref) = outs
    for name in ("means2d", "depths", "radii", "conic", "rect_min",
                 "rect_max", "tiles_touched"):
        assert torch.equal(getattr(got, name), getattr(sh, name)), name
    assert got.rgb is col and torch.equal(g_got[3], cot[2])
    held = ("means3d", "scales", "rotations") + (("offset",) if offset
                                                  else ())
    for name, g, p, r in zip(held, g_got[:3] + g_got[4:],
                             g_plain[:3] + g_plain[4:],
                             g_ref[:3] + g_ref[4:]):
        assert g.shape == p.shape, name
        cases.assert_held(name, g, p, r, case["groups"])


def _card_trainer():
    params, nets, cams, gts = make_scene("cuda")
    settings = rast.make_settings("seq", capacity=1 << 18, max_per_tile=8192,
                                  tight_culling=True)
    return sl.ScaffoldTrainer(params, nets, ROWS, settings,
                              first_iteration=FIRST,
                              cameras_extent=2.0), cams, gts


@pytest.mark.cuda
def test_the_step_reads_nothing_back_on_gpu():
    _need_gpu()
    tr, cams, gts = _card_trainer()
    tr.step(cams[0], gts[0], 0)        # builds and loads the kernels
    torch.cuda.synchronize()
    f0, b0 = pp.launches, pp.bwd_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            m = tr.step(cams[i % VIEWS], gts[i % VIEWS], i % VIEWS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the prefilter and the render forward, one backward, a step
    assert (pp.launches - f0, pp.bwd_launches - b0) == (6, 3)
    assert math.isfinite(float(m["loss"])) and int(m["dropped"]) == 0


@pytest.mark.cuda
def test_five_steps_repeat_bit_for_bit_on_gpu():
    _need_gpu()
    runs = []
    for _ in range(2):
        tr, cams, gts = _card_trainer()
        for i in range(5):
            tr.step(cams[i % VIEWS], gts[i % VIEWS], i % VIEWS)
        runs.append(tr.ts.params._asdict() | tr.ts.nets
                    | {f"mu.{k}": s.mu for k, s in tr.ts.opt_state.items()})
    for k, v in runs[0].items():
        assert torch.equal(v, runs[1][k]), k


def test_the_train_entry_trains_scaffold_gs(tmp_path, monkeypatch):
    """``python -m neuralgaussiansplatting_torch.train --model scaffold``
    in process on the CPU: anchors on the voxels of a demo scene's points,
    ``ScaffoldTrainer.step`` each iteration, the anchors and nets saved."""
    from neuralgaussiansplatting_torch.tools import make_demo_scene
    from neuralgaussiansplatting_torch.train import __main__ as entry
    scene_dir, out = tmp_path / "s", tmp_path / "o"
    make_demo_scene.main(["--out", str(scene_dir), "--size", "32", "--views",
                          "8", "--n_gaussians", "400", "--init_points",
                          "200", "--device", "cpu"])
    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    sl.steps = 0
    summary = entry.main(["-s", str(scene_dir), "-m", str(out), "--model",
                          "scaffold", "--iterations", "4", "--voxel_size",
                          "0.01", "--capacity", "65536", "--disable_viewer",
                          "--quiet"])
    assert sl.steps == 4 and summary["anchors"] == 200
    assert math.isfinite(summary["last_loss"])
    saved = torch.load(out / "scaffold" / "iteration_4" / "scaffold.pt",
                       weights_only=True)
    assert saved["params"]["offset"].shape == (200, scaffold.N_OFFSETS, 3)
    assert saved["nets"]["embedding_appearance.weight"].shape[1] == 32
