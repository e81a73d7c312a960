"""Plain 2D Gaussian Splatting training steps in PyTorch (Huang, Yu, Chen,
Geiger, Gao, "2D Gaussian Splatting for Geometrically Accurate Radiance
Fields", SIGGRAPH 2024, https://arxiv.org/abs/2403.17888; the code
github.com/hbb1/2d-gaussian-splatting and its rasterizer
diff-surfel-rasterization).

A surfel has a centre p, a rotation R whose first two columns are its
tangents t_u, t_v, two scales s_u, s_v (log-scales in the leaves), an
opacity (logit) and SH colours. Per view (``project``):

- the transform M = ndc2pix @ full_proj @ H, H = [[s_u t_u, s_v t_v, p],
  [0, 0, 1]], maps the surfel's (u, v, 1) to homogeneous pixels; its rows
  are T_u, T_v, T_w (ndc2pix the rasterizer's: x = ((ndc + 1) W - 1) / 2);
- the normal t_u x t_v = R's third column in view space, turned towards
  the camera (a surfel seen exactly edge-on is not drawn);
- the centre and the square's half-size from the bounding box of the
  surfel's 3-sigma ellipse (the repository's ``compute_aabb``, cutoff 3):
  t = (9, 9, -1), d = t . T_w^2, f = t / d, centre = (f . T_u T_w,
  f . T_v T_w), h = sqrt(max(1e-4, centre^2 - (f . T_u^2, f . T_v^2)));
  the radius ceil(max(h_x, h_y, 3 x 0.707106)) and the tile rect of the
  3DGS rasterizer from it; drawn when the view depth is above 0.2, d is
  not 0 and the opacity is above 0;
- colour from SH as ``render.sh_color`` (+ 0.5, clamped at 0).

Per (surfel, pixel) pair of the tiles of its rect (``composite_block``):
k = x T_w - T_u, l = y T_w - T_v, c = k x l, (u, v) = (c_x, c_y) / c_z,
rho3d = u^2 + v^2; rho2d = 2 |centre - (x, y)|^2 (the low-pass filter of
size sqrt(2)/2); rho = min(rho3d, rho2d); the depth z = u T_w.x + v T_w.y +
T_w.z where rho3d <= rho2d, else T_w.z; the pair is skipped when c_z is
0 or z < 0.2; alpha = min(0.99, opacity exp(-rho / 2)), skipped under
1/255, and the pixel stops before the pair that would take its
transmittance under 1e-4 (``render.composite_block``'s rules). Front to
back with weights w = alpha T, each pixel gets its colour (with the
background), alpha = 1 - T, the normal sum w n, the depth sum w z, the
median depth (the z of the last blended pair whose T before it is above
0.5; 0 where none) and the distortion sum w (m^2 A + M2 - 2 m M1), m = z
mapped to NDC between 0.2 and 100, A, M1, M2 the running sums of w, w m,
w m^2 before the pair.

The loss (``loss_fn``) is (1 - 0.2) L1 + 0.2 (1 - SSIM) of the image,
plus lambda_dist x the distortion's mean, plus lambda_normal x the mean of
1 - n_rendered . n_surf: n_rendered the normal sum in world space, n_surf
the normal of the depth map (the expected depth D / alpha where
``depth_ratio`` is 0, the median where it is 1, NaN and infinity read as
0) from finite differences of its points unprojected through the
rasterizer's pixel centres (cx = W / 2, as the repository's
``depths_to_points``), times alpha, detached. The gradient of every leaf
comes from autograd, the image's block by block as
``render.backward_image`` does; Adam is ``train.py``'s (betas 0.9, 0.999,
eps 1e-15) with the configuration's rates (by default the 2DGS
repository's, which are 3DGS's), each read at the step count.

Rules of the repository kept here, which the program shares: alpha's
gradient is taken as if it were not clamped at 0.99 (its backward uses
opacity x exp(-rho / 2)); the centre of the low-pass filter is
differentiated through its bounding box.

Departures from the paper and the repository, which the program shares:
the distortion is the repository's squared form (the paper's |z_i - z_j|
is not computed); tiles are 32 x 32 (the repository's 16 x 16); the surfel
set is fixed (no densification inside the checked steps: the cell starts
after it ends); a dead slot has opacity exactly 0 and is not drawn.

Written from those rules and ``render.py``'s alone: it imports nothing of
the program and takes nothing the program made. It computes in ``dtype``
(float32 unless a control asks for less) with TF32 off. ``affine`` is the
control that takes each pair's (u, v) from the transform's affine
approximation at the centre (3DGS's EWA splat) in place of the ray-splat
intersection. Pixels are evaluated on the ``sub`` x ``sub`` cells of a
surfel's tiles that the box of the pixels where alpha can reach 1/255
meets (the projected corners of the uv square of that level, with the
filter's disc; the whole rect where a corner lies behind the camera), in
blocks of at most ``pair_budget`` pairs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ngsbench.reference import render as ref

NEAR, FAR = 0.2, 100.0
FILTER_INV_SQUARE = 2.0          # 1 / (sqrt(2) / 2)^2
FILTER_SIZE = 0.707106
CUTOFF = 3.0
MEDIAN_T = 0.5
PAIR_BUDGET = 1 << 23
SUB = 8
B1, B2, EPS = 0.9, 0.999, 1e-15
# 2DGS's arguments/__init__.py defaults, which are 3DGS's: the higher SH
# bands at a twentieth of the features' rate, xyz on the exponential
# schedule (times the scene extent)
RATES = {"position": [0.00016, 0.0000016, 30_000], "feature": 0.0025,
         "opacity": 0.05, "scaling": 0.005, "rotation": 0.001}
LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def rate(rates: dict, leaf: str, count: int, extent: float) -> float:
    """``leaf``'s learning rate before update ``count + 1``."""
    if leaf == "xyz":
        init, final, steps_ = rates["position"]
        t = min(max(count / steps_, 0.0), 1.0)
        return extent * math.exp(math.log(init) * (1 - t)
                                 + math.log(final) * t)
    if leaf.startswith("features"):
        return rates["feature"] / (20.0 if leaf == "features_rest" else 1.0)
    return rates[leaf]


def _ndc2pix(cam, cx: float | None = None,
             cy: float | None = None) -> torch.Tensor:
    """(3, 4) float64: clip space to homogeneous pixels, the principal
    point at (cx, cy) ((W - 1) / 2, (H - 1) / 2: the rasterizer's)."""
    w, h = cam.width, cam.height
    cx = (w - 1) / 2.0 if cx is None else cx
    cy = (h - 1) / 2.0 if cy is None else cy
    return torch.tensor([[w / 2.0, 0, 0, cx], [0, h / 2.0, 0, cy],
                         [0, 0, 0, 1.0]], dtype=torch.float64)


def project(cloud: dict, cam, sh_degree: int, tile: int,
            dtype=torch.float32, sub: int = SUB) -> dict:
    """Per-surfel screen quantities of ``cloud`` (leaves xyz, scaling (N,
    2), rotation, opacity, features_dc, features_rest) seen by ``cam``,
    differentiable in the leaves: "T" (N, 3, 3) rows T_u, T_v, T_w;
    "centre" (N, 2); "normal" (N, 3) view space; "opacity", "rgb", "depth"
    (view z), "radius" (int64, 0 = not drawn), "rect" (N, 4) the sub-cells
    x0, y0, x1, y1 (exclusive) to evaluate, "unit" the cell's side."""
    dev = cloud["xyz"].device
    xyz = cloud["xyz"].to(dtype)
    n = xyz.shape[0]
    view = torch.as_tensor(cam.view, device=dev).to(dtype)
    full = torch.as_tensor(cam.full_proj, device=dev).to(dtype)
    campos = torch.as_tensor(cam.campos, device=dev).to(dtype)
    n2p = torch.as_tensor(_ndc2pix(cam), device=dev).to(dtype)
    wp = n2p @ full                                       # (3, 4)

    scale = torch.exp(cloud["scaling"].to(dtype))         # (N, 2)
    q = cloud["rotation"].to(dtype)
    q = q / torch.sqrt((q * q).sum(1, keepdim=True))
    r, qx, qy, qz = q.unbind(1)
    rot = torch.stack([
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - r * qz),
        2 * (qx * qz + r * qy),
        2 * (qx * qy + r * qz), 1 - 2 * (qx * qx + qz * qz),
        2 * (qy * qz - r * qx),
        2 * (qx * qz - r * qy), 2 * (qy * qz + r * qx),
        1 - 2 * (qx * qx + qy * qy)], 1).reshape(n, 3, 3)
    tu = rot[:, :, 0] * scale[:, 0:1]
    tv = rot[:, :, 1] * scale[:, 1:2]
    cols = [tu @ wp[:, :3].T, tv @ wp[:, :3].T, xyz @ wp[:, :3].T + wp[:, 3]]
    T = torch.stack(cols, 2)                              # (N, 3, 3)

    p_view = xyz @ view[:3, :3].T + view[:3, 3]
    depth = p_view[:, 2]
    nrm = rot[:, :, 2] @ view[:3, :3].T
    cos = -(p_view * nrm).sum(1)
    nrm = torch.where((cos > 0)[:, None], nrm, -nrm)

    tw = T[:, 2]
    t = torch.tensor([CUTOFF ** 2, CUTOFF ** 2, -1.0], dtype=dtype,
                     device=dev)
    d = (t * tw * tw).sum(1)
    f = t / torch.where(d == 0, torch.ones_like(d), d)[:, None]
    centre = torch.stack([(f * T[:, 0] * tw).sum(1),
                          (f * T[:, 1] * tw).sum(1)], 1)

    with torch.no_grad():
        h0 = centre.float() ** 2 - torch.stack(
            [(f * T[:, 0] * T[:, 0]).sum(1), (f * T[:, 1] * T[:, 1]).sum(1)],
            1).float()
        h = torch.sqrt(torch.clamp_min(h0, 1e-4))
        radius = torch.ceil(torch.clamp_min(h.amax(1), CUTOFF * FILTER_SIZE))
        w, hgt = cam.width, cam.height
        tiles_x, tiles_y = -(-w // tile), -(-hgt // tile)
        mx, my = centre[:, 0].float(), centre[:, 1].float()
        x0 = torch.clamp(torch.floor((mx - radius) / tile), 0, tiles_x)
        y0 = torch.clamp(torch.floor((my - radius) / tile), 0, tiles_y)
        x1 = torch.clamp(torch.floor((mx + radius + tile - 1) / tile), 0,
                         tiles_x)
        y1 = torch.clamp(torch.floor((my + radius + tile - 1) / tile), 0,
                         tiles_y)
        opacity0 = torch.sigmoid(cloud["opacity"].float()[:, 0])
        drawn = ((depth.float() > NEAR) & (d != 0) & (cos != 0)
                 & ((x1 - x0) * (y1 - y0) > 0) & (opacity0 > 0)
                 & torch.isfinite(radius))
        radius = torch.where(drawn, radius, 0).long()
        # The pixels where alpha can reach 1/255 have rho <= 2 ln(255 o):
        # the filter's disc round the centre, or the image of the uv disc
        # of that radius, which lies inside the projected corners of its
        # square while they are in front of the camera. Widened by a pixel
        # and a little more against rounding.
        level = 2 * torch.log(torch.clamp_min(opacity0 * 255.0, 1.0)) * 1.01
        rr = torch.sqrt(level)
        Tf = T.detach().float()
        xs, ys = [], []
        front = torch.ones_like(drawn)
        for su in (-1.0, 1.0):
            for sv in (-1.0, 1.0):
                hom = Tf[:, :, 0] * (su * rr)[:, None] + Tf[:, :, 1] * (
                    sv * rr)[:, None] + Tf[:, :, 2]
                front &= hom[:, 2] > 1e-6
                ww = torch.where(hom[:, 2] > 1e-6, hom[:, 2],
                                 torch.ones_like(hom[:, 2]))
                xs.append(hom[:, 0] / ww)
                ys.append(hom[:, 1] / ww)
        disc = torch.sqrt(level / FILTER_INV_SQUARE)
        bx0 = torch.minimum(torch.stack(xs).amin(0), mx - disc) - 1.0
        bx1 = torch.maximum(torch.stack(xs).amax(0), mx + disc) + 1.0
        by0 = torch.minimum(torch.stack(ys).amin(0), my - disc) - 1.0
        by1 = torch.maximum(torch.stack(ys).amax(0), my + disc) + 1.0
        k = tile // sub
        cx, cy = tiles_x * k, tiles_y * k
        inf = torch.full_like(bx0, float("inf"))
        bx0 = torch.where(front, bx0, -inf)
        by0 = torch.where(front, by0, -inf)
        bx1 = torch.where(front, bx1, inf)
        by1 = torch.where(front, by1, inf)
        x0 = torch.maximum(x0 * k, torch.clamp(torch.floor(bx0 / sub), 0, cx))
        y0 = torch.maximum(y0 * k, torch.clamp(torch.floor(by0 / sub), 0, cy))
        x1 = torch.minimum(x1 * k, torch.clamp(torch.floor(bx1 / sub) + 1, 0,
                                               cx))
        y1 = torch.minimum(y1 * k, torch.clamp(torch.floor(by1 / sub) + 1, 0,
                                               cy))
        reach = (x1 > x0) & (y1 > y0) & (opacity0 * 255.0 > 1.0)
        radius = torch.where(reach, radius, 0)
        rect = torch.stack([x0, y0, x1, y1], 1).long()

    dirs = xyz - campos
    dirs = dirs / torch.sqrt((dirs * dirs).sum(1, keepdim=True))
    sh = torch.cat([cloud["features_dc"], cloud["features_rest"]], 1)
    sh = sh.to(dtype).reshape(n, -1, 3)
    rgb = torch.clamp_min(ref.sh_color(sh_degree, sh, dirs) + 0.5, 0.0)
    opacity = torch.sigmoid(cloud["opacity"].to(dtype)[:, 0])
    return {"T": T, "centre": centre, "normal": nrm, "opacity": opacity,
            "rgb": rgb, "depth": depth, "radius": radius, "rect": rect,
            "unit": sub}


def _screen(scr: dict) -> ref.Screen:
    """``render.bin_tiles``' view of a surfel screen (its depths, radii and
    cells)."""
    z = scr["depth"]
    return ref.Screen(scr["centre"], z, z, z, z, scr["radius"], scr["rect"],
                      scr["unit"])


def _uv(Tu, Tv, Tw, px, py, affine: bool):
    """(u, v, c_z) of the pairs: the ray-splat intersection, or (affine)
    the transform's affine approximation at the centre."""
    if not affine:
        k = [px * Tw[i] - Tu[i] for i in range(3)]
        l_ = [py * Tw[i] - Tv[i] for i in range(3)]
        c = (k[1] * l_[2] - k[2] * l_[1], k[2] * l_[0] - k[0] * l_[2],
             k[0] * l_[1] - k[1] * l_[0])
        cz = torch.where(c[2] == 0, torch.ones_like(c[2]), c[2])
        return c[0] / cz, c[1] / cz, c[2]
    w2 = Tw[2]
    cx, cy = Tu[2] / w2, Tv[2] / w2
    a = (Tu[0] - cx * Tw[0]) / w2
    b = (Tu[1] - cx * Tw[1]) / w2
    c_ = (Tv[0] - cy * Tw[0]) / w2
    d = (Tv[1] - cy * Tw[1]) / w2
    det = a * d - b * c_
    det = torch.where(det == 0, torch.ones_like(det), det)
    dx, dy = px - cx, py - cy
    return (d * dx - b * dy) / det, (a * dy - c_ * dx) / det, det


def _unclamped(opg: torch.Tensor) -> torch.Tensor:
    """min(0.99, opg), whose gradient is opg's everywhere (the
    repository's backward)."""
    return opg - torch.clamp_min(opg - ref.ALPHA_MAX, 0.0).detach()


def composite_block(scr: dict, bins: ref.Bins, tiles, length: int,
                    bg: torch.Tensor, counts: dict | None = None,
                    affine: bool = False) -> dict:
    """{map: (B, P[, 3])} of the cells ``tiles``, their surfels padded to
    ``length``: "image" (with the background), "alpha", "normal",
    "depth", "median", "dist". With ``counts``, adds this block's pair
    counts (``render.composite_block``'s)."""
    dtype = scr["T"].dtype
    lanes = torch.arange(length, device=tiles.device)
    valid = lanes[None, :] < bins.count[tiles][:, None]           # (B, L)
    slot = torch.where(valid, bins.start[tiles][:, None] + lanes, 0)
    g = bins.gid[slot]
    px, py = ref._pixels(tiles, bins.tiles_x, bins.unit, dtype)
    T = scr["T"][g]                                               # (B,L,3,3)
    Tu = [T[..., 0, i, None] for i in range(3)]
    Tv = [T[..., 1, i, None] for i in range(3)]
    Tw = [T[..., 2, i, None] for i in range(3)]
    u, v, cz = _uv(Tu, Tv, Tw, px, py, affine)
    rho3d = u * u + v * v
    cen = scr["centre"][g]
    dx = cen[..., 0:1] - px
    dy = cen[..., 1:2] - py
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    on3d = rho3d <= rho2d
    rho = torch.where(on3d, rho3d, rho2d)
    z = torch.where(on3d, u * Tw[0] + v * Tw[1] + Tw[2],
                    Tw[2].expand_as(u))
    alpha = _unclamped(scr["opacity"][g][..., None] * torch.exp(-0.5 * rho))
    keep = ((cz != 0) & (z >= NEAR) & (alpha >= ref.ALPHA_MIN)
            & valid[..., None])
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    log_t = torch.log1p(-alpha)
    cum = torch.cumsum(log_t, 1)
    live = torch.exp(cum) >= ref.STOP_T
    t_before = torch.exp(cum - log_t)
    blended = live & keep
    w = torch.where(blended, alpha * t_before, torch.zeros_like(alpha))
    color = torch.einsum("blp,blc->bpc", w, scr["rgb"][g])
    normal = torch.einsum("blp,blc->bpc", w, scr["normal"][g])
    final_t = torch.exp(torch.where(live, log_t, torch.zeros_like(log_t))
                        .sum(1))
    zb = torch.where(blended, z, torch.ones_like(z))
    depth = (w * zb).sum(1)
    m = FAR / (FAR - NEAR) * (1 - NEAR / zb)
    wm, wm2 = w * m, w * m * m
    m1 = torch.cumsum(wm, 1) - wm
    m2 = torch.cumsum(wm2, 1) - wm2
    a_before = 1 - t_before
    dist = (w * (m * m * a_before + m2 - 2 * m * m1)).sum(1)
    mid = blended & (t_before > MEDIAN_T)
    last = torch.where(mid, lanes[None, :, None], -1).amax(1)     # (B, P)
    med = torch.gather(z, 1, last.clamp_min(0)[:, None])[:, 0]
    median = torch.where(last >= 0, med, torch.zeros_like(med))
    if counts is not None:
        with torch.no_grad():
            late = keep & ~live
            stop = late & (torch.cumsum(late.int(), 1) == 1)
            visited = blended | stop
            inst = visited.any(2)
            counts["fwd_pairs"] += int(visited.sum())
            counts["blended"] += int(blended.sum())
            counts["on3d"] += int((blended & on3d).sum())
            k = bins.per_tile
            t32 = ((tiles // bins.tiles_x) // k) * (bins.tiles_x // k) + (
                tiles % bins.tiles_x) // k
            counts["keys"].append((g * (bins.tiles_x * bins.tiles_y)
                                   + t32[:, None])[inst])
    return {"image": color + final_t[..., None] * bg.to(dtype),
            "alpha": 1 - final_t, "normal": normal, "depth": depth,
            "median": median, "dist": dist}


def _assemble(per_tile: torch.Tensor, bins: ref.Bins, width: int,
              height: int) -> torch.Tensor:
    """(T, P[, C]) cell-major pixels -> ([C,] H, W)."""
    if per_tile.dim() == 2:
        return ref._assemble(per_tile[..., None].expand(-1, -1, 3), bins,
                             width, height)[0]
    return ref._assemble(per_tile, bins, width, height)


def _per_tile(img: torch.Tensor, bins: ref.Bins) -> torch.Tensor:
    if img.dim() == 2:
        return ref._per_tile(img[None].expand(3, -1, -1), bins)[..., 0]
    return ref._per_tile(img, bins)


def render(cloud: dict, cam, sh_degree: int, bg: torch.Tensor, tile: int,
           dtype=torch.float32, counts: bool = False, affine: bool = False,
           pair_budget: int = PAIR_BUDGET, sub: int = SUB) -> dict:
    """{"maps": {name: detached map}, "screen", "bins", "blocks"[,
    "counts"]}: the surfels of ``cloud`` seen by ``cam``; ``counts`` as
    ``render.render``'s, and "on3d", the blended pairs whose alpha the
    ray-splat intersection set (rho3d <= rho2d)."""
    scr = project(cloud, cam, sh_degree, tile, dtype, sub)
    with torch.no_grad():
        bins = ref.bin_tiles(_screen(scr), cam.width, cam.height, tile)
        pix = sub * sub
        n = bins.tiles_x * bins.tiles_y
        dev = bg.device
        out = {"image": bg.to(dtype).expand(n, pix, 3).clone(),
               "alpha": torch.zeros((n, pix), dtype=dtype, device=dev),
               "normal": torch.zeros((n, pix, 3), dtype=dtype, device=dev)}
        for name in ("depth", "median", "dist"):
            out[name] = torch.zeros((n, pix), dtype=dtype, device=dev)
        c = ({"fwd_pairs": 0, "blended": 0, "on3d": 0, "keys": []} if counts
             else None)
        blocks = ref._blocks(bins.count, pix, pair_budget)
        for tiles, length in blocks:
            part = composite_block(scr, bins, tiles, length, bg, c, affine)
            for name, x in part.items():
                out[name][tiles] = x
        maps = {k: _assemble(v, bins, cam.width, cam.height)
                for k, v in out.items()}
    res = {"maps": maps, "screen": scr, "bins": bins, "blocks": blocks}
    if counts:
        found = c.pop("keys")
        keys = (torch.unique(torch.cat(found)) if found
                else torch.zeros(0, dtype=torch.int64))
        c["instances"] = int(keys.numel())
        c["gaussians_needed"] = int(torch.unique(
            keys // (bins.tiles_x * bins.tiles_y)).numel())
        c["pixels"] = cam.width * cam.height
        c["drawn"] = int((scr["radius"] > 0).sum())
        res["counts"] = c
    return res


def depth_to_normal(cam, depth: torch.Tensor) -> torch.Tensor:
    """(3, H, W) world normals of the (H, W) depth map: its pixels
    unprojected (cx = W / 2, cy = H / 2, the focal lengths of the
    projection), the cross product of their central differences along the
    rows and the columns, normalised; zero on the border."""
    dev, dtype = depth.device, depth.dtype
    f64 = torch.float64
    c2w = torch.linalg.inv(torch.as_tensor(cam.view).to(f64))
    proj = torch.as_tensor(cam.full_proj).to(f64) @ c2w
    intr = (_ndc2pix(cam, cam.width / 2.0, cam.height / 2.0) @ proj)[:, :3]
    ray = c2w[:3, :3] @ torch.linalg.inv(intr)           # pixel -> world dir
    h, w = depth.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=dev, dtype=dtype),
                            torch.arange(w, device=dev, dtype=dtype),
                            indexing="ij")
    pix = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    dirs = pix @ torch.as_tensor(ray.T, dtype=dtype, device=dev)
    pts = depth[..., None] * dirs + torch.as_tensor(c2w[:3, 3], dtype=dtype,
                                                    device=dev)
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    nrm = F.normalize(torch.cross(dx, dy, dim=-1), dim=-1)
    out = torch.zeros_like(pts)
    out[1:-1, 1:-1] = nrm
    return out.permute(2, 0, 1)


def loss_fn(maps: dict, gt: torch.Tensor, cam, *, lambda_dssim: float,
            lambda_normal: float, lambda_dist: float, depth_ratio: float,
            rows: int | None = None) -> torch.Tensor:
    """The 2DGS loss of ``render``'s maps (see the module docstring).
    ``rows`` keeps only the first rows of the photometric term (a fault
    the checks must catch)."""
    loss = ref.loss_fn(maps["image"], gt, lambda_dssim, rows)
    alpha = maps["alpha"]
    if lambda_dist:
        loss = loss + lambda_dist * maps["dist"].mean()
    if lambda_normal:
        view = torch.as_tensor(cam.view).to(device=alpha.device,
                                            dtype=alpha.dtype)
        nw = torch.einsum("ji,jhw->ihw", view[:3, :3], maps["normal"])
        expected = torch.nan_to_num(maps["depth"] / alpha, 0.0, 0.0)
        median = torch.nan_to_num(maps["median"], 0.0, 0.0)
        surf = expected * (1 - depth_ratio) + depth_ratio * median
        sn = depth_to_normal(cam, surf) * alpha.detach()
        loss = loss + lambda_normal * (1 - (nw * sn).sum(0)).mean()
    return loss


def backward_maps(res: dict, cloud: dict, cot: dict, bg: torch.Tensor,
                  affine: bool = False) -> dict:
    """{leaf: gradient} of sum <cot[m], maps[m]> of ``render``'s ``res``
    (whose screen is differentiable in ``cloud``'s leaves): the screen's
    gradients block by block (each block recomputed under autograd), then
    back through the projection."""
    scr, bins = res["screen"], res["bins"]
    names = ("T", "centre", "normal", "opacity", "rgb")
    free = {k: scr[k].detach().requires_grad_() for k in names}
    fscr = scr | free
    dtype = scr["T"].dtype
    per = {k: _per_tile(c.to(dtype), bins) for k, c in cot.items()}
    for tiles, length in res["blocks"]:
        part = composite_block(fscr, bins, tiles, length, bg, None, affine)
        torch.autograd.backward([part[k] for k in per],
                                [per[k][tiles] for k in per])
    torch.autograd.backward(
        [scr[k] for k in names],
        [free[k].grad if free[k].grad is not None
         else torch.zeros_like(free[k]) for k in names])
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v))
            for k, v in cloud.items()}


def step_maps(params: dict, cam, gt, bg, *, sh_degree: int, tile: int,
              dtype=torch.float32, affine: bool = False,
              pair_budget: int = PAIR_BUDGET, **loss_kw):
    """(loss, {leaf: gradient}, maps, counts) of one view."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    res = render(leaves, cam, sh_degree, bg, tile, dtype, counts=True,
                 affine=affine, pair_budget=pair_budget)
    maps = {k: v.detach().requires_grad_() for k, v in res["maps"].items()}
    loss = loss_fn(maps, gt, cam, **loss_kw)
    gmaps = torch.autograd.grad(loss, list(maps.values()), allow_unused=True)
    cot = {k: g for k, g in zip(maps, gmaps) if g is not None}
    grads = backward_maps(res, leaves, cot, bg, affine)
    return (float(loss.detach()), grads,
            {k: v.detach() for k, v in res["maps"].items()}, res["counts"])


def steps(cloud: dict, cams, gts, bg, *, sh_degree: int, tile: int,
          extent: float, lambda_dssim: float = 0.2,
          lambda_normal: float = 0.05, lambda_dist: float = 0.0,
          depth_ratio: float = 0.0, rates: dict = RATES,
          dtype=torch.float32, affine: bool = False,
          loss_rows: int | None = None,
          pair_budget: int = PAIR_BUDGET) -> dict:
    """Train ``cloud`` (``LEAVES``) one step per camera of ``cams``
    against ``gts``.

    Returns {"loss": [per step], "grad": {leaf: the first step's gradient},
    "change_norm": {leaf: norm of the change over the steps}, "maps": [per
    step, ``render``'s maps], "counts": [per step], "params": {leaf: after
    the steps}}. ``loss_rows`` keeps the first rows of each image in the
    photometric term (a fault the checks must catch)."""
    params = {k: cloud[k].detach().to(dtype).clone() for k in LEAVES}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in params.items()}
    out = {"loss": [], "grad": None, "maps": [], "counts": []}
    kw = dict(lambda_dssim=lambda_dssim, lambda_normal=lambda_normal,
              lambda_dist=lambda_dist, depth_ratio=depth_ratio,
              rows=loss_rows)
    for i, (cam, gt) in enumerate(zip(cams, gts)):
        loss, grads, maps, c = step_maps(
            params, cam, gt, bg, sh_degree=sh_degree, tile=tile,
            dtype=dtype, affine=affine, pair_budget=pair_budget, **kw)
        if i == 0:
            out["grad"] = {k: g.float() for k, g in grads.items()}
        for k, g in grads.items():
            m, v = moments[k]
            m = B1 * m + (1 - B1) * g
            v = B2 * v + (1 - B2) * g * g
            moments[k] = (m, v)
            lr = rate(rates, k, i, extent)
            step = (m / (1 - B1 ** (i + 1))) / (
                torch.sqrt(v / (1 - B2 ** (i + 1))) + EPS)
            params[k] = params[k] - lr * step
        out["loss"].append(loss)
        out["maps"].append(maps)
        out["counts"].append(c)
    out["change_norm"] = {k: float((params[k].float() - cloud[k].float())
                                   .norm()) for k in params}
    out["params"] = params
    return out
