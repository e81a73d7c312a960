"""Plain Scaffold-GS training steps in PyTorch (Lu et al., CVPR 2024;
github.com/city-super/Scaffold-GS, ``gaussian_renderer/__init__.py`` and
``train.py`` with the default switches: no feature bank, no distance
inputs).

Each step follows the original's own order: the visibility prefilter of
the anchors (``prefilter``: the rasterizer's radius > 0 for a Gaussian of
scales ``l[:3]``, identity rotation, on the square tile rect); boolean
compaction of the visible anchors; the three MLPs on ``[f, d]`` (and the
appearance embedding's row of the view for the colour); the expansion into
``n_offsets`` neural Gaussians an anchor and boolean compaction of those
whose opacity is above 0 (``generate``); their screen-space Gaussians by
``render.project`` (given the opacity's logit for its culling, then the
opacity and colour themselves), composited by ``render``'s rules
(``bin_tiles``, ``composite_block``); the loss (1 - lambda) L1 + lambda
(1 - SSIM) + 0.01 x the mean of the kept Gaussians' scale products; the
gradient of every leaf by autograd, the image's block by block as
``render.backward_image`` does; and Adam (betas 0.9, 0.999, eps 1e-15)
with the configuration's per-group rates, each schedule read at the
iteration.

Departures from the original, which the program shares: the anchors are
fixed (no growing or pruning; the cell starts after they end); the
anchors' rotation and opacity, which take no gradient, are not carried.
The reference compacts where the program keeps dead slots: both are the
same set of Gaussians.

Written from those rules and ``render.py``'s alone: it imports nothing of
the program and takes nothing the program made. It computes in ``dtype``
(float32 unless a control asks for less; ``mlp_dtype`` the MLPs' alone)
with TF32 off (``render.no_tf32``); ``mlp_tf32`` gives the MLPs' matrix
products TF32's operands (``tf32``), a control that leaves the rest in
float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ngsbench.reference import render as ref

B1, B2, EPS = 0.9, 0.999, 1e-15
ANCHOR_LEAVES = ("anchor", "offset", "anchor_feat", "scaling")


def settings(cfg: dict, first_iteration: int) -> dict:
    """The configuration's widths, loss and rates, as ``steps`` takes
    them, for steps from ``first_iteration``."""
    return {"n_offsets": cfg["n_offsets"], "tile": cfg["pipeline"]["tile"],
            "lambda_dssim": cfg["lambda_dssim"],
            "scale_reg": cfg["scale_regulariser"], "rates": cfg["rates"],
            "first_iteration": first_iteration}


def nets_shapes(cfg: dict, views: int) -> dict:
    """{leaf: shape} of the MLPs (Linear(in, hidden) -> ReLU ->
    Linear(hidden, out), the original's ``nn.Sequential`` names) and the
    appearance embedding, at the configuration's widths, for ``views``
    training cameras."""
    f, k, h = cfg["feat_dim"], cfg["n_offsets"], cfg["mlp_hidden"]
    a, c = cfg["appearance_dim"], cfg["cov_dim"]
    out = {}
    for name, cin, cout in (("mlp_opacity", f + 3, k),
                            ("mlp_cov", f + 3, c * k),
                            ("mlp_color", f + 3 + a, 3 * k)):
        out |= {f"{name}.0.weight": (h, cin), f"{name}.0.bias": (h,),
                f"{name}.2.weight": (cout, h), f"{name}.2.bias": (cout,)}
    out["embedding_appearance.weight"] = (views, a)
    return out


def rate(rates: dict, leaf: str, iteration: int, extent: float) -> float:
    """The rate of ``leaf``'s group at ``iteration``: a constant, or a
    log-linear blend of [init, final] over ``max_steps`` (x the scene
    extent for the anchors and offsets)."""
    r = rates[leaf.split(".")[0]]
    if not isinstance(r, list):
        return float(r)
    init, final = r
    if leaf in ("anchor", "offset"):
        init, final = init * extent, final * extent
    if init == 0.0 and final == 0.0:
        return 0.0
    t = min(max(iteration / rates["max_steps"], 0.0), 1.0)
    return math.exp(math.log(init) * (1 - t) + math.log(final) * t)


def prefilter(anchor: torch.Tensor, scaling: torch.Tensor, cam,
              tile: int) -> torch.Tensor:
    """(N,) bool: anchors in front of the 0.2 near plane whose EWA
    covariance (scales exp(scaling[:, :3]), identity rotation, the 0.3 px
    low-pass, the 1.3 tan(fov) clamp) has a non-zero determinant and whose
    3-sigma square touches a tile of the image."""
    with torch.no_grad():
        dt = anchor.dtype
        dev = anchor.device
        view = torch.as_tensor(cam.view, device=dev).to(dt)
        full = torch.as_tensor(cam.full_proj, device=dev).to(dt)
        s2 = torch.exp(scaling[:, :3]) ** 2
        t = anchor @ view[:3, :3].T + view[:3, 3]
        depth = t[:, 2]
        hom = anchor @ full[:, :3].T + full[:, 3]
        wh = hom[:, 3:4] + 1e-7
        wh = torch.where(wh.abs() < 1e-6,
                         torch.full_like(wh, 1e-6).copysign(wh), wh)
        ndc = hom[:, :2] / wh
        w, h = cam.width, cam.height
        mx = ((ndc[:, 0] + 1) * w - 1) * 0.5
        my = ((ndc[:, 1] + 1) * h - 1) * 0.5
        fx, fy = w / (2 * cam.tan_fovx), h / (2 * cam.tan_fovy)
        tz = torch.where(depth.abs() < 0.01, torch.full_like(depth, 0.01),
                         depth)
        tx = torch.clamp(t[:, 0] / tz, -1.3 * cam.tan_fovx,
                         1.3 * cam.tan_fovx) * tz
        ty = torch.clamp(t[:, 1] / tz, -1.3 * cam.tan_fovy,
                         1.3 * cam.tan_fovy) * tz
        zero = torch.zeros_like(tz)
        jac = torch.stack([fx / tz, zero, -fx * tx / (tz * tz),
                           zero, fy / tz, -fy * ty / (tz * tz)],
                          1).reshape(-1, 2, 3)
        tm = jac @ view[:3, :3]
        cov = (tm * s2[:, None, :]) @ tm.transpose(1, 2)
        cxx, cxy, cyy = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3
        det = cxx * cyy - cxy * cxy
        mid = 0.5 * (cxx + cyy)
        disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius = torch.ceil(3 * torch.sqrt(torch.maximum(mid + disc,
                                                         mid - disc)))
        tiles_x, tiles_y = -(-w // tile), -(-h // tile)
        x0 = torch.clamp(torch.floor((mx - radius) / tile), 0, tiles_x)
        y0 = torch.clamp(torch.floor((my - radius) / tile), 0, tiles_y)
        x1 = torch.clamp(torch.floor((mx + radius + tile - 1) / tile), 0,
                         tiles_x)
        y1 = torch.clamp(torch.floor((my + radius + tile - 1) / tile), 0,
                         tiles_y)
        return (depth > ref.NEAR) & (det != 0) & ((x1 - x0) * (y1 - y0) > 0)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) with its mantissa rounded to TF32's 10 bits, to
    nearest with ties away from zero: a float32 operand as a tensor core
    reads it with TF32 on."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    """``F.linear`` of (N, in) rows as a matrix product with TF32 on
    computes it, on any device: the operands of each product, forward and
    both gradients', rounded by ``tf32``, the sums in float32."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.linear(tf32(x), tf32(w), b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g32 = tf32(g)
        return g32 @ tf32(w), g32.T @ tf32(x), g.sum(0)


def _mlp(x, nets: dict, name: str, dtype, tf32_operands: bool = False):
    def p(key):
        return nets[f"{name}.{key}"].to(dtype)

    linear = _TF32Linear.apply if tf32_operands else F.linear
    hid = F.relu(linear(x.to(dtype), p("0.weight"), p("0.bias")))
    return linear(hid, p("2.weight"), p("2.bias"))


def generate(params: dict, nets: dict, cam, view: int, visible, k: int,
             mlp_dtype=None, mlp_tf32: bool = False) -> dict:
    """The original's ``generate_neural_gaussians``: the kept neural
    Gaussians of the visible anchors ("xyz", "color", "opacity",
    "scaling", "rotation", rows in anchor order) and "gate" (N x k,) bool,
    the candidates kept, in the program's row order."""
    dt = params["anchor"].dtype
    mdt = mlp_dtype or dt
    feat = params["anchor_feat"][visible]
    anchor = params["anchor"][visible]
    offsets = params["offset"][visible]
    grid = torch.exp(params["scaling"][visible])
    campos = torch.as_tensor(cam.campos, device=anchor.device).to(dt)
    ob = anchor - campos
    ob = ob / ob.norm(dim=1, keepdim=True)
    local = torch.cat([feat, ob], 1)
    app = nets["embedding_appearance.weight"][view].to(dt)
    app = app[None].expand(anchor.shape[0], -1)
    neural_opacity = torch.tanh(_mlp(local, nets, "mlp_opacity", mdt,
                                     mlp_tf32))
    neural_opacity = neural_opacity.to(dt).reshape(-1, 1)
    mask = (neural_opacity > 0.0).view(-1)
    opacity = neural_opacity[mask]
    color = torch.sigmoid(_mlp(torch.cat([local, app], 1), nets,
                               "mlp_color", mdt, mlp_tf32))
    color = color.to(dt).reshape(-1, 3)
    scale_rot = _mlp(local, nets, "mlp_cov", mdt, mlp_tf32)
    scale_rot = scale_rot.to(dt).reshape(-1, 7)
    rep = torch.repeat_interleave(torch.cat([grid, anchor], -1), k, 0)
    masked = torch.cat([rep, color, scale_rot, offsets.reshape(-1, 3)],
                       -1)[mask]
    grid_r, anchor_r, color, scale_rot, offsets = masked.split(
        [6, 3, 3, 7, 3], dim=-1)
    scaling = grid_r[:, 3:] * torch.sigmoid(scale_rot[:, :3])
    rotation = F.normalize(scale_rot[:, 3:7], dim=-1)
    xyz = anchor_r + offsets * grid_r[:, :3]
    gate = torch.zeros((visible.shape[0], k), dtype=torch.bool,
                       device=visible.device)
    gate[visible] = mask.reshape(-1, k)
    return {"xyz": xyz, "color": color, "opacity": opacity[:, 0],
            "scaling": scaling, "rotation": rotation,
            "gate": gate.reshape(-1)}


def _screen(gen: dict, cam, tile: int, dtype):
    """``render.project``'s screen of the generated Gaussians, its culling
    given their opacity, differentiable in their attributes."""
    m = gen["xyz"].shape[0]
    cloud = {"xyz": gen["xyz"], "scaling": torch.log(gen["scaling"]),
             "rotation": gen["rotation"],
             "opacity": torch.logit(gen["opacity"].detach().float())[:, None],
             "features_dc": gen["xyz"].new_zeros((m, 3)),
             "features_rest": gen["xyz"].new_zeros((m, 0))}
    scr = ref.project(cloud, cam, 0, tile, dtype)
    return scr._replace(opacity=gen["opacity"], rgb=gen["color"])


def forward(leaves: dict, cam, view: int, bg, *, n_offsets: int,
            tile: int, dtype=torch.float32, mlp_dtype=None,
            mlp_tf32: bool = False,
            pair_budget: int = ref.PAIR_BUDGET) -> dict:
    """One view's forward from ``leaves`` (the anchors' and the nets'):
    "image" (3, H, W) detached, "visible", "generated" (``generate``),
    "screen" (differentiable in the leaves), "bins", "blocks", "reg" (the
    kept Gaussians' mean scale product, differentiable), "bg" and "counts"
    (``render.render``'s, and "anchors", "visible_anchors", "kept")."""
    vis = prefilter(leaves["anchor"], leaves["scaling"], cam, tile)
    gen = generate(leaves, leaves, cam, view, vis, n_offsets, mlp_dtype,
                   mlp_tf32)
    scr = _screen(gen, cam, tile, dtype)
    s = gen["scaling"]
    reg = (s[:, 0] * s[:, 1] * s[:, 2]).mean() if s.shape[0] else s.sum()
    with torch.no_grad():
        bins = ref.bin_tiles(scr, cam.width, cam.height, tile)
        pix = scr.unit * scr.unit
        per_tile = torch.zeros((bins.tiles_x * bins.tiles_y, pix, 3),
                               dtype=dtype, device=bg.device)
        per_tile[:] = bg.to(dtype)
        c = {"fwd_pairs": 0, "blended": 0, "keys": []}
        blocks = ref._blocks(bins.count, pix, pair_budget)
        for tiles, length in blocks:
            per_tile[tiles] = ref.composite_block(scr, bins, tiles, length,
                                                  bg, c)
        img = ref._assemble(per_tile, bins, cam.width, cam.height)
        found = c.pop("keys")
        keys = (torch.unique(torch.cat(found)) if found
                else torch.zeros(0, dtype=torch.int64))
    c["instances"] = int(keys.numel())
    c["gaussians_needed"] = int(torch.unique(
        keys // (bins.tiles_x * bins.tiles_y)).numel())
    c["pixels"] = cam.width * cam.height
    c["drawn"] = int((scr.radius > 0).sum())
    c["anchors"] = int(vis.shape[0])
    c["visible_anchors"] = int(vis.sum())
    c["kept"] = int(gen["gate"].sum())
    return {"image": img, "visible": vis, "generated": gen, "screen": scr,
            "bins": bins, "blocks": blocks, "reg": reg, "bg": bg,
            "counts": c}


def backward(f: dict, leaves: dict, gimg: torch.Tensor,
             scale_reg: float) -> dict:
    """{leaf: gradient} of <gimg, image> + scale_reg x reg of ``forward``'s
    ``f``: the screen-space gradients block by block (each block's pixels
    recomputed under autograd), then back through the projection and the
    generation."""
    scr, bins = f["screen"], f["bins"]
    screen = [scr.means2d, scr.conic, scr.opacity, scr.rgb]
    sfree = [t.detach().requires_grad_() for t in screen]
    fscr = scr._replace(means2d=sfree[0], conic=sfree[1], opacity=sfree[2],
                        rgb=sfree[3])
    cot = ref._per_tile(gimg.to(scr.conic.dtype), bins)
    for tiles, length in f["blocks"]:
        part = ref.composite_block(fscr, bins, tiles, length, f["bg"])
        torch.autograd.backward(part, cot[tiles])
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in sfree]
    reg = f["reg"]
    torch.autograd.backward(screen + [reg], grads + [
        torch.tensor(scale_reg, dtype=reg.dtype, device=reg.device)])
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v))
            for k, v in leaves.items()}


def steps(params: dict, nets: dict, cams, views, gts, bg, *, n_offsets: int,
          tile: int, lambda_dssim: float, scale_reg: float, rates: dict,
          first_iteration: int, extent: float, dtype=torch.float32,
          mlp_dtype=None, mlp_tf32: bool = False,
          loss_rows: int | None = None,
          pair_budget: int = ref.PAIR_BUDGET) -> dict:
    """Train from ``params`` (``ANCHOR_LEAVES``) and ``nets`` one step per
    camera of ``cams`` (training view ``views[i]``) against ``gts``.

    Returns {"loss": [per step], "grad": {leaf: the first step's
    gradient}, "change_norm": {leaf: norm of the change over the steps},
    "params": {leaf: after the steps}, "gate": [per step, (N x n_offsets,)
    bool], "visible": [per step, (N,) bool], "counts": [per step,
    ``forward``'s]}. ``loss_rows`` keeps the first rows of each image in
    the loss (a fault the checks must catch)."""
    leaves = {k: v.detach().to(dtype).clone()
              for k, v in (params | nets).items()}
    start = {k: v.clone() for k, v in leaves.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in leaves.items()}
    out = {"loss": [], "grad": None, "gate": [], "visible": [],
           "counts": []}
    for i, (cam, view, gt) in enumerate(zip(cams, views, gts)):
        free = {k: v.detach().requires_grad_() for k, v in leaves.items()}
        f = forward(free, cam, view, bg, n_offsets=n_offsets, tile=tile,
                    dtype=dtype, mlp_dtype=mlp_dtype, mlp_tf32=mlp_tf32,
                    pair_budget=pair_budget)
        img = f["image"].detach().requires_grad_()
        photo = ref.loss_fn(img, gt, lambda_dssim, loss_rows)
        (gimg,) = torch.autograd.grad(photo, [img])
        grad = backward(f, free, gimg, scale_reg)
        if i == 0:
            out["grad"] = {k: g.float() for k, g in grad.items()}
        it = first_iteration + i
        for k, g in grad.items():
            m, v = moments[k]
            m = B1 * m + (1 - B1) * g
            v = B2 * v + (1 - B2) * g * g
            moments[k] = (m, v)
            step = (m / (1 - B1 ** (i + 1))) / (
                torch.sqrt(v / (1 - B2 ** (i + 1))) + EPS)
            leaves[k] = leaves[k] - rate(rates, k, it, extent) * step
        out["loss"].append(float(photo.detach())
                           + scale_reg * float(f["reg"].detach()))
        out["gate"].append(f["generated"]["gate"])
        out["visible"].append(f["visible"])
        out["counts"].append(f["counts"])
        del free, f
    out["change_norm"] = {k: float((leaves[k].float() - start[k].float())
                                   .norm()) for k in leaves}
    out["params"] = leaves
    return out
