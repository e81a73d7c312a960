"""2D Gaussian Splatting in the port (``preprocess.preprocess_surfels``,
``ops/surfel_blend.py``, ``rasterize.rasterize_surfels``,
``gaussian_renderer.render_surfel``, the surfel terms of ``train.loop``)
against the benchmark's plain reference (``ngsbench/reference/surfel.py``),
on the CPU at a small size: 300 seeded surfels, 64 x 48.

Tolerances, each with its reason:

- ``MAP_TOL``: every map (image, alpha, normal, depth, median depth,
  distortion) to 1e-4 of the larger of 1 and the map's largest value. The
  port and the reference both compute in float32 but in other orders (the
  transform's product, the reference's cumulative-log transmittance); at
  this seed they differ by at most 1.2e-5 of the scale. The reference with
  3DGS's affine splat in place of the intersection differs by ~1e-2.
- ``GRAD_TOL``: each leaf's gradient to 5e-4 of its norm. At this seed they
  differ by at most 2.5e-5; float32's own conditioning of the
  intersection's gradient (k = x T_w - T_u cancels near the centre) puts
  the reference itself ~1e-3 from its float64 run on views with a surfel
  seen at a grazing angle, which this view does not hold. The affine
  splat's gradients differ by ~0.4.
- The loss to 1e-5 of itself and the norm of one Adam step's change per
  leaf to 1e-3 of itself (a gradient near 0 may take the other sign).
"""

import math

import pytest
import torch

from neuralgaussiansplatting_torch import gaussian_renderer as gr
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import blend
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops.transforms import quat_to_rotmat
from neuralgaussiansplatting_torch.train import densify, loop, optim

from ngsbench.reference import surfel as ref

import surfel_cases as sc

W, H, N = 64, 48, 300
MAP_TOL = 1e-4
GRAD_TOL = 5e-4
PORT_MAPS = {"image": "render", "alpha": "rend_alpha",
             "normal": "rend_normal", "depth": "rend_depth",
             "median": "rend_median", "dist": "rend_dist"}


def _settings():
    return rast.make_settings("seq", capacity=1 << 14, max_per_tile=4096,
                              precise_cull=False)


@pytest.fixture(scope="module")
def case():
    """The seeded surfels, the camera, random cotangents of every map, and
    for the port, the reference and the affine control their maps and the
    leaves' gradients of sum <cotangent, map>."""
    torch.manual_seed(0)
    leaves = sc.cloud(N, 1, log_scale=math.log(0.08))
    cam = sc.camera(W, H)
    bg = torch.tensor([0.1, 0.2, 0.3])
    out = {"leaves": leaves, "cam": cam, "bg": bg}
    g = torch.Generator().manual_seed(2)
    for name, affine in (("ref", False), ("affine", True)):
        free = {k: v.detach().requires_grad_() for k, v in leaves.items()}
        res = ref.render(free, cam, 3, bg, 32, affine=affine)
        if name == "ref":
            out["cot"] = {k: torch.randn(v.shape, generator=g)
                          for k, v in res["maps"].items()}
        grads = ref.backward_maps(res, free, out["cot"], bg, affine)
        out[name] = (res["maps"], grads)
    p = {k: v.detach().requires_grad_() for k, v in leaves.items()}
    o = gr.render(sc.port_camera(cam, "cpu"), sc.params(p),
                  torch.ones(N, dtype=torch.bool), 3, bg, _settings())
    maps = {k: o[v] for k, v in PORT_MAPS.items()}
    total = sum((maps[k] * out["cot"][k]).sum() for k in maps)
    grads = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
    out["port"] = ({k: v.detach() for k, v in maps.items()}, grads)
    return out


def _map_gaps(a: dict, b: dict) -> dict:
    return {k: float((a[k] - b[k]).abs().max())
            / max(1.0, float(b[k].abs().max())) for k in b}


def _grad_gaps(a: dict, b: dict) -> dict:
    return {k: float((a[k] - b[k]).norm() / b[k].norm()) for k in b}


def test_every_map_matches_the_reference(case):
    gaps = _map_gaps(case["port"][0], case["ref"][0])
    assert max(gaps.values()) <= MAP_TOL, gaps
    assert float(case["ref"][0]["dist"].abs().max()) > 0


def test_every_gradient_matches_the_reference(case):
    gaps = _grad_gaps(case["port"][1], case["ref"][1])
    assert max(gaps.values()) <= GRAD_TOL, gaps


def test_the_affine_splat_fails_the_tolerances(case):
    """The reference with 3DGS's affine (EWA) splat, held to the same
    tolerances: a port computing the pair so would not pass."""
    maps = _map_gaps(case["affine"][0], case["ref"][0])
    grads = _grad_gaps(case["affine"][1], case["ref"][1])
    assert max(maps.values()) > 10 * MAP_TOL, maps
    assert max(grads.values()) > 10 * GRAD_TOL, grads


def _trainer_step_against_the_reference(depth_ratio: float):
    """``Trainer.step`` at iteration 15001 (both regularisers on, lambda_d
    100, the surface depth by ``depth_ratio``) against one reference step:
    the loss, the first gradient (Adam's first moment over 1 - beta1) and
    the norm of Adam's change."""
    leaves = sc.cloud(N, 3, log_scale=math.log(0.08))
    cam = sc.camera(W, H, pos=(-0.5, -0.3, -3.2))
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(4))
    model = sc.model({k: v.clone() for k, v in leaves.items()})
    tr = loop.Trainer(gaussians=model, opt=optim.OptimizationParams(),
                      settings=_settings(), cameras_extent=2.0,
                      lambda_normal=0.05, lambda_dist=100.0,
                      depth_ratio=depth_ratio)
    m = tr.step(sc.port_camera(cam, "cpu"), gt, 15001)
    r = ref.steps(leaves, [cam], [gt], torch.zeros(3), sh_degree=3, tile=32,
                  extent=2.0, lambda_normal=0.05, lambda_dist=100.0,
                  depth_ratio=depth_ratio)
    assert abs(float(m["loss"]) - r["loss"][0]) <= 1e-5 * r["loss"][0]
    grads = {k: tr.ts.opt_state[k].mu / (1 - tr.tx.b1) for k in leaves}
    gaps = _grad_gaps(grads, r["grad"])
    assert max(gaps.values()) <= GRAD_TOL, gaps
    for k in leaves:
        moved = float((getattr(tr.ts.params, k) - leaves[k]).norm())
        assert abs(moved - r["change_norm"][k]) <= 1e-3 * r["change_norm"][k]
    assert set(m["maps"]) == {"rend_normal", "rend_depth", "rend_dist",
                              "rend_alpha"}
    return r


def test_one_trainer_step_matches_the_reference():
    _trainer_step_against_the_reference(0.0)


def test_one_trainer_step_on_the_median_depth_matches_the_reference():
    """depth_ratio 1 (the 2DGS repository's setting for bounded scenes):
    the normal term reads the median depth, whose gradient reaches the
    surfels through the median pair's depth."""
    r = _trainer_step_against_the_reference(1.0)
    assert float(r["maps"][0]["median"].abs().max()) > 0


def test_the_regularisers_start_at_their_iterations():
    model = sc.model(sc.cloud(8, 5))
    tr = loop.Trainer(gaussians=model, settings=_settings(),
                      lambda_normal=0.05, lambda_dist=100.0)
    assert tr.surfel_terms(3000) == (0.0, 0.0, 0.0)
    assert tr.surfel_terms(3001) == (0.0, 100.0, 0.0)
    assert tr.surfel_terms(7001) == (0.05, 100.0, 0.0)


def test_the_split_samples_in_the_tangent_plane():
    """A split of a surfel draws its samples in its tangent plane (the
    third deviation 0): each sample's offset from the centre is orthogonal
    to the normal; both take scaling / 1.6."""
    leaves = sc.cloud(64, 6, log_scale=math.log(0.5))
    model = sc.model(leaves)
    params = gm.repad(model.params, model.state, 128)
    p, state = params
    state = state._replace(xyz_gradient_accum=torch.where(
        state.alive, 1.0, 0.0), denom=torch.where(state.alive, 1.0, 0.0))
    tr_opt = optim.make_optimizer(optim.OptimizationParams(), 1.0)
    new, st, _, report = densify.densify_and_prune(
        p, state, tr_opt.init(p), torch.Generator().manual_seed(7), 2e-4,
        0.0, 1.0, False, 0.01)
    assert int(report.num_split) == 64
    normal = quat_to_rotmat(p.rotation[:64])[:, :, 2]
    for d in (new.xyz[:64] - p.xyz[:64], new.xyz[64:] - p.xyz[:64]):
        assert float((d * normal).sum(1).abs().max()) <= 1e-6
        assert float(d.norm(dim=1).min()) > 0
    assert torch.allclose(new.scaling[:64], torch.log(
        torch.exp(p.scaling[:64]) / 1.6), atol=1e-6)
    assert torch.equal(new.scaling[64:], new.scaling[:64])


def test_a_two_scale_model_round_trips_through_ply(tmp_path):
    leaves = sc.cloud(50, 8)
    model = sc.model(leaves)
    path = str(tmp_path / "surfels.ply")
    model.save_ply(path)
    names = gm.ply_attribute_names(model.params)
    assert "scale_1" in names and "scale_2" not in names
    back = gm.GaussianModel(3, device="cpu")
    back.load_ply(path)
    for k in sc.LEAVES:
        assert torch.equal(getattr(back.params, k), leaves[k]), k
    assert back.params.scaling.shape == (50, 2)


def test_the_train_entry_trains_2dgs(tmp_path, monkeypatch):
    """``python -m neuralgaussiansplatting_torch.train --model 2dgs`` in
    process on the CPU: surfels from a demo scene's points, trained
    through ``Trainer.step``, saved with two scales."""
    from neuralgaussiansplatting_torch.tools import make_demo_scene
    from neuralgaussiansplatting_torch.train import __main__ as entry
    scene_dir, out = tmp_path / "s", tmp_path / "o"
    make_demo_scene.main(["--out", str(scene_dir), "--size", "16", "--views",
                          "4", "--n_gaussians", "100", "--init_points",
                          "50", "--device", "cpu"])
    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    summary = entry.main(["-s", str(scene_dir), "-m", str(out), "--model",
                          "2dgs", "--iterations", "2", "--lambda_dist",
                          "10", "--capacity", "65536", "--disable_viewer",
                          "--quiet"])
    assert math.isfinite(summary["last_loss"])
    back = gm.GaussianModel(3, device="cpu")
    back.load_ply(str(out / "point_cloud" / "iteration_2" /
                      "point_cloud.ply"))
    assert back.params.scaling.shape[1] == 2


def _former_pack(means2d, conic, opacity, rgb):
    """``pack_instance_attrs_t`` as it read before it took other row
    counts."""
    packed = torch.stack([
        means2d[:, 0], means2d[:, 1], conic[:, 0], conic[:, 1], conic[:, 2],
        opacity, rgb[:, 0], rgb[:, 1], rgb[:, 2]], dim=0).float()
    return torch.cat([packed, packed.new_zeros((9, 1))], dim=1)


def _former_reduce(cot9, gid, n):
    """``reduce_by_gaussian`` as it read before it took other row
    counts."""
    sums = blend.sum_rows_by_id(cot9.t(), gid, n)
    return torch.cat([sums, sums.new_zeros((1, 9))]).t().contiguous()


def test_the_nine_row_table_is_bit_equal_to_the_former_code():
    g = torch.Generator().manual_seed(9)
    n, k = 500, 3000
    attrs = (torch.randn((n, 2), generator=g),
             torch.randn((n, 3), generator=g),
             torch.rand((n,), generator=g), torch.rand((n, 3), generator=g))
    gid = torch.randint(0, n + 1, (k,), generator=g, dtype=torch.int32)
    packed = blend.pack_instance_attrs_t(*attrs)
    assert torch.equal(packed, _former_pack(*attrs))
    cot = torch.randn((9, k), generator=g)
    assert torch.equal(blend.reduce_by_gaussian(cot, gid, n),
                       _former_reduce(cot, gid, n))
    leaf = packed.clone().requires_grad_()
    (got,) = torch.autograd.grad((blend.pack_gather(leaf, gid) * cot).sum(),
                                 [leaf])
    assert torch.equal(got, _former_reduce(cot, gid, n))


def test_the_table_takes_a_surfels_eighteen_rows():
    g = torch.Generator().manual_seed(10)
    n, k = 40, 200
    packed = blend.pack_instance_attrs_t(
        torch.randn((n, 2), generator=g), torch.randn((n, 9), generator=g),
        torch.rand((n,), generator=g), torch.rand((n, 3), generator=g),
        torch.randn((n, 3), generator=g)).requires_grad_()
    assert packed.shape == (18, n + 1)
    gid = torch.randint(0, n + 1, (k,), generator=g, dtype=torch.int32)
    cot = torch.randn((18, k), generator=g)
    (got,) = torch.autograd.grad((blend.pack_gather(packed, gid) * cot)
                                 .sum(), [packed])
    want = torch.zeros((18, n + 1))
    keep = gid.long() < n
    want.index_add_(1, gid.long()[keep], cot[:, keep])
    want[:, n] = 0
    assert torch.allclose(got, want, atol=1e-5)


def test_the_surfel_route_refuses_what_it_cannot_run():
    leaves = sc.cloud(20, 11)
    cam = sc.port_camera(sc.camera(W, H), "cpu")
    p = sc.params(leaves)
    alive = torch.ones(20, dtype=torch.bool)
    with pytest.raises(ValueError, match="seq route"):
        gr.render(cam, p, alive, 3, torch.zeros(3),
                  rast.make_settings("pallas"))
    with pytest.raises(ValueError, match="no surfel preprocess"):
        pp.preprocess_surfels(*(t.to("meta") for t in (
            p.xyz, torch.exp(p.scaling), p.rotation, p.opacity[:, 0])),
            None, 0, cam, 32, 32)
