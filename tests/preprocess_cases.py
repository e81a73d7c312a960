"""Seeded preprocess inputs for the preprocess kernels' tests: a bulk of
Gaussians in front of the demo camera and the edge rows every case carries.

Imports no JAX, so the card tests can use it. Inputs are made with numpy
from the seed and moved to the device, so a case is the same on any device.

Edge rows (``EDGES`` names them, in order after the bulk):

- ``dead``: exactly-zero opacity (capacity-padding slots);
- ``behind``: behind the camera;
- ``near``: in front of it, inside the 0.2 near plane, some inside the
  |z| < 0.01 floor, one exactly at the camera centre (a zero view
  direction, under the normalisation's 1e-16 guard);
- ``clamp``: large Gaussians whose centres lie outside the frustum limits
  in x, y or both, so the EWA clamp is active and they still touch the
  image;
- ``degenerate``: scales of 1e-7 on one, two or three axes, and
  quaternions of norm 1e-9 (under the 1e-16 guard) or far from unit.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.parallel.render_sp import strip_cameras

EDGES = ("dead", "behind", "near", "clamp", "degenerate")
SH_C0 = 0.28209479177387814


def camera(w: int, h: int, device, strip: bool = False):
    """The demo camera at ``w`` x ``h``, turned a little about y; with
    ``strip``, strip 1 of 4 of a ``w`` x 4h frame (its own projection rows,
    the full frame's frustum limits)."""
    if not strip:
        return demo.demo_camera(w, h, angle_y=0.3, device=device)
    full = demo.demo_camera(w, 4 * h, angle_y=0.3, device="cpu")
    strips = strip_cameras(full, 4)
    cam = strips.camera(1)
    return type(cam)(cam.view, cam.full_proj, cam.campos, cam.tan_fovx,
                     cam.tan_fovy, cam.width, cam.height, cam.limit_x,
                     cam.limit_y, device=device)


def _edge_rows(rng, cam_pos: np.ndarray, tan_x: float, tan_y: float,
               view: np.ndarray):
    """(means, scales, quats, opacities, group name per row) of the edge
    rows, in world space for a camera at ``cam_pos`` with world-to-view
    ``view``."""
    c2w = np.linalg.inv(view.astype(np.float64))

    def world(p):  # view-space points -> world
        p = np.asarray(p, np.float64)
        return (p @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32)

    rows = []

    def add(name, view_pts, scale, quat=(1.0, 0.0, 0.0, 0.0), opacity=0.8):
        for p in view_pts:
            rows.append((name, world(p), np.broadcast_to(
                np.asarray(scale, np.float32), (3,)),
                np.asarray(quat, np.float32), np.float32(opacity)))

    inside = [(0.1 * k, -0.05 * k, 3.0 + 0.2 * k) for k in range(6)]
    add("dead", inside, 0.05, opacity=0.0)
    add("behind", [(0.1, 0.2, -1.0), (0.0, 0.0, -0.15), (-0.3, 0.1, -5.0)],
        0.3)
    add("near", [(0.01, 0.02, 0.1), (0.0, 0.0, 0.19), (0.02, 0.0, 0.005),
                 (0.0, 0.01, -0.004)], 0.05)
    rows.append(("near", cam_pos.astype(np.float32),
                 np.full(3, 0.05, np.float32),
                 np.asarray((1.0, 0.0, 0.0, 0.0), np.float32),
                 np.float32(0.8)))
    lx, ly = 1.3 * tan_x, 1.3 * tan_y
    clamp_pts = []
    for z in (2.0, 3.5):
        for fx, fy in ((1.15, 0.0), (-1.3, 0.2), (0.1, 1.2), (-0.2, -1.4),
                       (1.2, 1.25)):
            clamp_pts.append((fx * lx * z, fy * ly * z, z))
    add("clamp", clamp_pts, 0.6)
    quats = [(0.3, -0.5, 0.8, 0.1), (1e-9, 0.0, 0.0, 0.0),
             (0.0, 2e-10, -5e-10, 1e-10), (40.0, -3.0, 7.0, 25.0)]
    scales = [(1e-7, 1e-7, 1e-7), (1e-7, 0.05, 0.05), (0.08, 1e-7, 1e-7),
              (0.05, 0.05, 0.05)]
    for k, (s, q) in enumerate(zip(scales, quats)):
        add("degenerate", [(0.05 * k - 0.1, 0.03 * k, 2.5 + 0.3 * k)], s, q)
    names = [r[0] for r in rows]
    return (np.stack([r[1] for r in rows]), np.stack([r[2] for r in rows]),
            np.stack([r[3] for r in rows]), np.stack([r[4] for r in rows]),
            names)


def make_case(n: int, deg: int, seed: int, cam, stored_deg: int = 3,
              device="cpu") -> dict:
    """``n`` bulk Gaussians and the edge rows, as the activated inputs of
    ``preprocess_gaussians``: {"means3d", "scales", "rotations",
    "opacities", "shs" (N, (stored_deg + 1)^2, 3), "offset" (N, 2),
    "groups" (name per row), "deg"}. The bulk fills the view frustum at
    depths 1.5-8 with log-normal scales, unnormalised quaternions,
    opacities in (0.005, 1) and SH rows whose colours reach below 0."""
    rng = np.random.default_rng(seed)
    view = cam.view.cpu().numpy()
    c2w = np.linalg.inv(view.astype(np.float64))
    depth = rng.uniform(1.5, 8.0, n)
    vx = rng.uniform(-1.1, 1.1, n) * cam.tan_fovx * depth
    vy = rng.uniform(-1.1, 1.1, n) * cam.tan_fovy * depth
    pv = np.stack([vx, vy, depth], -1)
    means = (pv @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32)
    scales = np.exp(rng.normal(-3.8, 0.9, (n, 3))).astype(np.float32)
    quats = rng.normal(0.0, 1.0, (n, 4)).astype(np.float32)
    quats *= rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    opac = rng.uniform(0.005, 1.0, n).astype(np.float32)
    e_means, e_scales, e_quats, e_opac, e_names = _edge_rows(
        rng, cam.campos.cpu().numpy(), cam.tan_fovx, cam.tan_fovy, view)
    means = np.concatenate([means, e_means])
    scales = np.concatenate([scales, e_scales])
    quats = np.concatenate([quats, e_quats])
    opac = np.concatenate([opac, e_opac])
    total = means.shape[0]
    k = (stored_deg + 1) ** 2
    shs = rng.normal(0.0, 0.35, (total, k, 3)).astype(np.float32)
    shs[:, 0] = ((rng.random((total, 3)) - 0.5) / SH_C0).astype(np.float32)
    offset = rng.normal(0.0, 1e-3, (total, 2)).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"means3d": t(means), "scales": t(scales), "rotations": t(quats),
            "opacities": t(opac), "shs": t(shs), "offset": t(offset),
            "groups": ["bulk"] * n + e_names, "deg": deg}


def append_edges(inputs: dict, cam, seed: int = 0) -> tuple[dict, list]:
    """``inputs`` (the activated inputs of ``preprocess_gaussians``, as
    ``make_case`` names them, on one device) with the edge rows for ``cam``
    appended, their SH and offset rows drawn from ``seed``; and the group
    name of every row ("bulk" for the rows given)."""
    rng = np.random.default_rng(seed)
    view = cam.view.cpu().numpy()
    e_means, e_scales, e_quats, e_opac, names = _edge_rows(
        rng, cam.campos.cpu().numpy(), cam.tan_fovx, cam.tan_fovy, view)
    m = len(names)
    sh_shape = (m,) + tuple(inputs["shs"].shape[1:])  # (K, 3) or flat
    edges = {"means3d": e_means, "scales": e_scales, "rotations": e_quats,
             "opacities": e_opac,
             "shs": rng.normal(0.0, 0.35, sh_shape).astype(np.float32),
             "offset": rng.normal(0.0, 1e-3, (m, 2)).astype(np.float32)}
    out = {key: torch.cat([inputs[key], torch.from_numpy(edges[key]).to(
        inputs[key].device)]) for key in edges}
    return out, ["bulk"] * inputs["means3d"].shape[0] + names


def magnitude_bands(groups, ref: torch.Tensor, cut: float = 0.999) -> list:
    """``groups`` with each bulk row's name followed by its band of
    magnitude, by where its largest finite |value| of ``ref`` (N, ...)
    ranks among the bulk's: "bulk body" up to the ``cut`` quantile, "bulk
    top" above it ("bulk 0" a row of zeros, which must come out zero,
    "bulk -" one with no finite value). ``assert_held`` then reads a row's
    error against the largest row of its band, so that a few
    ill-conditioned rows with gradients of ~1e6 (a cloud around the camera,
    as ``chip_smoke.py``'s garden one, holds Gaussians near its plane) set
    the scale of their own band and not of the rest; ``make_case``'s bulk
    lies in front of the camera, so its tests keep the group. The body is
    wide on purpose: a row whose gradient cancels to a small value carries
    rounding noise of its terms' size, in any float32 order, so it is read
    against a scale it shares with many rows (a band per decade read such
    rows at 2-3x the float32 plain version's error on the card). The edge
    rows keep their group for the same reason (a quaternion under the
    1e-16 guard gives gradients of ~1e-19)."""
    r = ref.detach().reshape(ref.shape[0], -1).double()
    r = torch.where(torch.isfinite(r), r.abs(), -1.0).amax(dim=1).cpu()
    live = torch.from_numpy(np.asarray(groups) == "bulk") & (r > 0)
    edge = float("inf")
    if live.any():
        ranked = torch.sort(r[live]).values
        edge = float(ranked[int(cut * (ranked.numel() - 1))])
    def band(v):
        return "-" if v < 0 else "0" if v == 0 else (
            "body" if v <= edge else "top")

    return [g if g != "bulk" else f"bulk {band(v)}"
            for g, v in zip(groups, r.tolist())]


def upstream(radii: torch.Tensor, seed: int) -> tuple:
    """Gradients of means2d, conic and rgb as the blend gives them: seeded
    normal values on rows that render (radii > 0), zero on culled rows."""
    g = torch.Generator().manual_seed(seed)
    n = radii.shape[0]
    live = (radii > 0).cpu()[:, None]
    outs = []
    for cols, scale in ((2, 1e-2), (3, 1e-1), (3, 1.0)):
        v = torch.randn((n, cols), generator=g) * scale
        outs.append(torch.where(live, v, 0.0).to(radii.device))
    return tuple(outs)


def rounding_floats(case: dict, cam, block_x: int, block_y: int,
                    tight: bool) -> tuple[dict, dict]:
    """The plain version's float32 values that its integer outputs round or
    compare, recomputed from ``case``'s inputs with its own helpers:
    ({name: values floored or ceiled}, {name: (values, threshold)}). The
    radius before ceil; the rect corners before floor; with ``tight``, the
    per-axis extents before ceil and the corners they give; and the depth
    against the 0.2 near plane, the opacity term 2 log(255 op) against 0."""
    m, op = case["means3d"], case["opacities"]
    fx = cam.width / (2.0 * cam.tan_fovx)
    fy = cam.height / (2.0 * cam.tan_fovy)
    cxx, cxy, cyy, _ = pp._cov2d_components(
        m, case["scales"], case["rotations"], cam.view, fx, fy, cam.limit_x,
        cam.limit_y, 1.0)
    det = cxx * cyy - cxy * cxy
    mid = 0.5 * (cxx + cyy)
    d2 = mid * mid - det
    d2 = torch.where(torch.isfinite(d2), d2, 0.1)
    disc = torch.sqrt(torch.clamp_min(d2, 0.1))
    r_pre = 3.0 * torch.sqrt(torch.maximum(mid + disc, mid - disc))
    rad = torch.ceil(r_pre)
    ndc = proj.project_points(m, cam.full_proj)
    x = proj.ndc2pix(ndc[:, 0], cam.width)
    y = proj.ndc2pix(ndc[:, 1], cam.height)
    floats = {"radius": r_pre,
              "lo": torch.stack([(x - rad) / block_x, (y - rad) / block_y]),
              "hi": torch.stack([(x + rad + block_x - 1) / block_x,
                                 (y + rad + block_y - 1) / block_y])}
    depth = proj.transform_points_4x3(m, cam.view)[:, 2]
    two_l = 2.0 * torch.log(torch.clamp_min(op, 1e-12) * 255.0)
    limits = {"depth": (depth, 0.2)}
    if tight:
        ext = torch.sqrt(torch.clamp_min(
            torch.clamp_min(two_l, 0.0)[None] * torch.stack([cxx, cyy]),
            0.0))
        e = torch.minimum(rad, torch.ceil(ext))
        blk = torch.tensor([[block_x], [block_y]], device=m.device)
        pix = torch.stack([x, y])
        floats.update(ext=ext, tight_lo=(pix - e) / blk,
                      tight_hi=(pix + e) / blk)
        limits["two_l"] = (two_l, 0.0)
    return floats, limits


def boundary_rows(floats: dict, limits: dict,
                  rel: float = 1e-5) -> torch.Tensor:
    """(N,) bool: rows with a value of ``floats`` ((..., N) each) within
    ``rel`` of an integer, or of ``limits`` within ``rel`` of its
    threshold, relative to max(1, |value|)."""
    flag = None

    def add(near):
        nonlocal flag
        near = near.reshape(-1, near.shape[-1]).any(dim=0)
        flag = near if flag is None else flag | near

    for v in floats.values():
        v = v.double()
        add((v - v.round()).abs() <= rel * v.abs().clamp_min(1.0))
    for v, t in limits.values():
        v = v.double()
        add((v - t).abs() <= rel * v.abs().clamp_min(1.0))
    return flag


def finite_scale(t: torch.Tensor) -> float:
    """The largest finite |value| of ``t`` (0 if none)."""
    t = t[torch.isfinite(t)]
    return float(t.abs().max()) if t.numel() else 0.0


def run_pass(fn, case, cam, block, tight, offset, leaves=None,
             dtype=torch.float32):
    """``fn`` (``preprocess_gaussians`` or its plain version) on ``case``'s
    inputs at ``block`` x ``block`` tiles, in ``dtype`` (the camera too),
    with ``leaves`` (name -> tensor) in place of the case's tensors and the
    case's offset where ``offset``."""
    c = {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
             else v) for k, v in case.items()}
    if leaves is not None:
        c.update(leaves)
    if dtype != torch.float32:
        cam = copy.copy(cam)
        for k in ("view", "full_proj", "campos"):
            setattr(cam, k, getattr(cam, k).to(dtype))
    return fn(c["means3d"], c["scales"], c["rotations"], c["opacities"],
              c["shs"], c["deg"], cam, block, block, tight=tight,
              means2d_offset=c["offset"] if offset else None)


def assert_held(name, got, plain, ref, groups, scale=None):
    """Assert ``got`` is as close to the float64 ``ref`` as the float32
    ``plain`` is (twice its worst error), or within 1e-5 of the scale, in
    each group of rows (``groups``: a name per row, as ``make_case``
    gives, or ``magnitude_bands``): the edge rows' values, far larger or
    smaller than the bulk's, are read against their own. ``scale`` is each
    row's, or None for the group's largest finite |value|; a group whose
    reference is all zero (rows that render nothing get no gradient) must
    be zero. Returns the largest error, as a share of its scale."""
    got, plain, ref = got.detach(), plain.detach(), ref.detach()
    scale = None if scale is None else scale.detach()
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fin), name
    names = np.array(groups)
    worst = 0.0
    for group in dict.fromkeys(groups):
        rows = torch.from_numpy(np.nonzero(names == group)[0]).to(ref.device)
        g, p, r, f = got[rows], plain[rows], ref[rows], fin[rows]
        s = finite_scale(r) if scale is None else scale[rows]
        if scale is None and s == 0.0:
            assert not g[f].any(), (name, group)
            continue
        e_got = float(((g.double() - r).abs() / s)[f].max())
        e_plain = float(((p.double() - r).abs() / s)[f].max())
        print(f"{name} ({group}): {e_got:.3e} of its scale from the "
              f"float64 plain version; the float32 plain version "
              f"{e_plain:.3e}")
        assert e_got <= max(1e-5, 2.0 * e_plain), (name, group)
        worst = max(worst, e_got)
    return worst


def row_scale(name, want, cam):
    """Each row's scale of forward field ``name`` against which its error
    is read: the frame's size for means2d, one world unit for depths, the
    row's larger diagonal term for the conic, 1 for colours."""
    if name == "means2d":
        return torch.clamp_min(want.abs(), float(max(cam.width,
                                                      cam.height)))
    if name == "depths":
        return torch.clamp_min(want.abs(), 1.0)
    if name == "conic":
        big = torch.maximum(want[:, 0].abs(), want[:, 2].abs())
        return torch.maximum(want.abs(), big[:, None])
    return torch.clamp_min(want.abs(), 1.0)
