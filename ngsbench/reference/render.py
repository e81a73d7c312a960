"""A plain 3D Gaussian splatting forward pass in PyTorch.

The rules are those of the 3DGS paper's rasterizer (Kerbl et al. 2023):
project each Gaussian, take its EWA screen covariance with the 0.3 px
low-pass and the 1.3 x tan(fov) frustum clamp, its 3-sigma square radius
and the tiles that square touches; colour from SH up to degree 3 plus 0.5,
clamped at 0; then per pixel, over the Gaussians of the pixel's tile in
depth order: alpha = min(0.99, opacity exp(power)), skipped when under
1/255 or when power > 0, and the pixel stops before the Gaussian that
would take its transmittance under 1e-4. The tile size is the
configuration's (32 x 32 for the port's main path).

Written from those rules alone: it shares no code with the program, and
computes in ``dtype`` (float32 unless a control asks for less) with TF32
off. A Gaussian is a candidate for the pixels of the tiles its square
touches; it is evaluated on the ``sub`` x ``sub`` pixel cells of those
tiles that the bounding box of its alpha = 1/255 ellipse reaches (no pixel
outside that box can blend, so the image is the same at any ``sub``; only
the work shrinks). Cells are computed in blocks of at most ``pair_budget``
(Gaussian, pixel) pairs, so that it fits beside nothing else on the card.
With ``counts`` it also returns the per-pixel pair counts the rooflines
use (``counts.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
STOP_T = 1e-4
NEAR = 0.2
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
PAIR_BUDGET = 1 << 25
SUB = 8


def no_tf32():
    """Turn TF32 off for matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Screen(NamedTuple):
    """Per-Gaussian screen-space quantities of one view."""

    means2d: torch.Tensor   # (N, 2) pixel coordinates
    conic: torch.Tensor     # (N, 3) inverse covariance (a, b, c)
    opacity: torch.Tensor   # (N,)
    rgb: torch.Tensor       # (N, 3)
    depth: torch.Tensor     # (N,)
    radius: torch.Tensor    # (N,) int64, 0 = not drawn
    rect: torch.Tensor      # (N, 4) int64 cells x0, y0, x1, y1 (x1, y1
                            # exclusive) of its tiles that can hold a pixel
                            # with alpha >= 1/255
    unit: int               # a cell's side in pixels


def sh_color(degree: int, sh: torch.Tensor, dirs: torch.Tensor):
    """Real SH of (N, 16, 3) coefficients at unit directions (N, 3)."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    out = SH_C0 * sh[:, 0]
    if degree >= 1:
        out = (out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2]
               - SH_C1 * x * sh[:, 3])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out = (out + SH_C2[0] * x * y * sh[:, 4] + SH_C2[1] * y * z * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * x * z * sh[:, 7]
               + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + SH_C3[1] * x * y * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return out


def project(cloud: dict, cam, sh_degree: int, tile: int,
            dtype=torch.float32, sub: int = SUB) -> Screen:
    """The screen-space Gaussians of ``cloud`` (``scene.make_cloud``'s
    leaves) seen by ``cam`` (a ``scene.Camera``),
    differentiable in the cloud's leaves; ``tile`` divisible by ``sub``."""
    dev = cloud["xyz"].device
    xyz = cloud["xyz"].to(dtype)
    view = torch.as_tensor(cam.view, device=dev).to(dtype)
    full = torch.as_tensor(cam.full_proj, device=dev).to(dtype)
    campos = torch.as_tensor(cam.campos, device=dev).to(dtype)
    n = xyz.shape[0]

    scale = torch.exp(cloud["scaling"].to(dtype))
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
    m = rot * scale[:, None, :]
    sigma = m @ m.transpose(1, 2)                       # (N, 3, 3) world

    t = xyz @ view[:3, :3].T + view[:3, 3]
    depth = t[:, 2]
    hom = xyz @ full[:, :3].T + full[:, 3]
    wh = hom[:, 3:4] + 1e-7
    # a point on the camera plane would divide by ~0: keep |w| >= 1e-6
    wh = torch.where(wh.abs() < 1e-6, torch.full_like(wh, 1e-6).copysign(wh),
                     wh)
    ndc = hom[:, :2] / wh
    w, h = cam.width, cam.height
    means2d = torch.stack([((ndc[:, 0] + 1) * w - 1) * 0.5,
                           ((ndc[:, 1] + 1) * h - 1) * 0.5], 1)

    fx = w / (2 * cam.tan_fovx)
    fy = h / (2 * cam.tan_fovy)
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    tz = torch.where(depth.abs() < 0.01, torch.full_like(depth, 0.01), depth)
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([fx / tz, zero, -fx * tx / (tz * tz),
                       zero, fy / tz, -fy * ty / (tz * tz)], 1).reshape(n, 2, 3)
    tm = jac @ view[:3, :3]
    cov = tm @ sigma @ tm.transpose(1, 2)
    cxx = cov[:, 0, 0] + 0.3
    cxy = cov[:, 0, 1]
    cyy = cov[:, 1, 1] + 0.3
    det = cxx * cyy - cxy * cxy
    safe = torch.where(det == 0, torch.ones_like(det), det)
    conic = torch.stack([cyy / safe, -cxy / safe, cxx / safe], 1)

    with torch.no_grad():
        mid = 0.5 * (cxx + cyy).float()
        disc = torch.sqrt(torch.clamp_min(mid * mid - det.float(), 0.1))
        lam = torch.maximum(mid + disc, mid - disc)
        radius = torch.ceil(3 * torch.sqrt(lam))
        tiles_x, tiles_y = -(-w // tile), -(-h // tile)
        mx, my = means2d[:, 0].float(), means2d[:, 1].float()
        x0 = torch.clamp(torch.floor((mx - radius) / tile), 0, tiles_x)
        y0 = torch.clamp(torch.floor((my - radius) / tile), 0, tiles_y)
        x1 = torch.clamp(torch.floor((mx + radius + tile - 1) / tile), 0,
                         tiles_x)
        y1 = torch.clamp(torch.floor((my + radius + tile - 1) / tile), 0,
                         tiles_y)
        opacity0 = torch.sigmoid(cloud["opacity"].float()[:, 0])
        drawn = ((depth.float() > NEAR) & (det != 0) & ((x1 - x0) * (y1 - y0) > 0)
                 & (opacity0 > 0) & torch.isfinite(radius))
        radius = torch.where(drawn, radius, 0).long()
        # Only pixels inside the bounding box of the alpha = 1/255 ellipse
        # can blend: its half-widths are sqrt(2 ln(255 opacity) cov), here
        # widened by a pixel against rounding. Tiles of the square that
        # miss the box hold no pair that blends, so they are left out.
        level = 2 * torch.log(torch.clamp_min(opacity0 * 255.0, 1.0))
        ex = torch.sqrt(level * cxx.float()) + 1.0
        ey = torch.sqrt(level * cyy.float()) + 1.0
        k = tile // sub
        cx, cy = tiles_x * k, tiles_y * k
        x0 = torch.maximum(x0 * k, torch.clamp(torch.floor((mx - ex) / sub),
                                               0, cx))
        y0 = torch.maximum(y0 * k, torch.clamp(torch.floor((my - ey) / sub),
                                               0, cy))
        x1 = torch.minimum(x1 * k, torch.clamp(
            torch.floor((mx + ex) / sub) + 1, 0, cx))
        y1 = torch.minimum(y1 * k, torch.clamp(
            torch.floor((my + ey) / sub) + 1, 0, cy))
        reach = (x1 > x0) & (y1 > y0) & (opacity0 * 255.0 > 1.0)
        radius = torch.where(reach, radius, 0)
        rect = torch.stack([x0, y0, x1, y1], 1).long()

    dirs = xyz - campos
    dirs = dirs / torch.sqrt((dirs * dirs).sum(1, keepdim=True))
    sh = torch.cat([cloud["features_dc"], cloud["features_rest"]], 1)
    sh = sh.to(dtype).reshape(n, -1, 3)
    rgb = torch.clamp_min(sh_color(sh_degree, sh, dirs) + 0.5, 0.0)
    opacity = torch.sigmoid(cloud["opacity"].to(dtype)[:, 0])
    return Screen(means2d, conic, opacity, rgb, depth, radius, rect, sub)


class Bins(NamedTuple):
    """Each cell's Gaussians in depth order: ``gid[start[c]:start[c] +
    count[c]]``; cells are ``unit`` pixels square, ``per_tile`` of them a
    tile's side."""

    gid: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    tiles_x: int            # in cells
    tiles_y: int
    unit: int
    per_tile: int


def bin_tiles(scr: Screen, width: int, height: int, tile: int) -> Bins:
    """Every drawn Gaussian once per cell of its rect, sorted by cell and
    then by depth."""
    k = tile // scr.unit
    tiles_x, tiles_y = -(-width // tile) * k, -(-height // tile) * k
    dev = scr.depth.device
    drawn = torch.nonzero(scr.radius > 0)[:, 0]
    rect = scr.rect[drawn]
    rw = rect[:, 2] - rect[:, 0]
    per = rw * (rect[:, 3] - rect[:, 1])
    owner = torch.repeat_interleave(torch.arange(drawn.numel(), device=dev),
                                    per)
    first = torch.cumsum(per, 0) - per
    local = torch.arange(owner.numel(), device=dev) - first[owner]
    tx = rect[owner, 0] + local % rw[owner]
    ty = rect[owner, 1] + local // rw[owner]
    tile_id = ty * tiles_x + tx
    gid = drawn[owner]
    order = torch.sort(scr.depth.detach().float()[gid], stable=True)[1]
    order = order[torch.sort(tile_id[order], stable=True)[1]]
    gid, tile_id = gid[order], tile_id[order]
    count = torch.bincount(tile_id, minlength=tiles_x * tiles_y)
    start = torch.cumsum(count, 0) - count
    return Bins(gid, start, count, tiles_x, tiles_y, scr.unit, k)


def _blocks(count: torch.Tensor, pix: int, budget: int):
    """Blocks of tiles (most crowded first) whose padded pair count stays
    within ``budget``: a list of (tile index tensor, padded length)."""
    order = torch.argsort(count, descending=True)
    c = count[order].tolist()
    blocks, i = [], 0
    while i < len(c) and c[i] > 0:
        length = c[i]
        b = max(1, budget // (length * pix))
        blocks.append((order[i:i + b], length))
        i += b
    return blocks


def _pixels(tiles: torch.Tensor, tiles_x: int, tile: int, dtype):
    """(B, 1, P) pixel x and y of each tile's pixels (x fastest)."""
    j = torch.arange(tile * tile, device=tiles.device)
    px = (tiles[:, None] % tiles_x) * tile + j % tile
    py = (tiles[:, None] // tiles_x) * tile + j // tile
    return px[:, None, :].to(dtype), py[:, None, :].to(dtype)


def composite_block(scr: Screen, bins: Bins, tiles, length: int,
                    bg: torch.Tensor, counts: dict | None = None):
    """(B, P, 3) colour with background of the cells ``tiles``, their
    Gaussians padded to ``length``. With ``counts``, adds this block's pair
    counts to it (see ``render``)."""
    tile = bins.unit
    dtype = scr.conic.dtype
    lanes = torch.arange(length, device=tiles.device)
    valid = lanes[None, :] < bins.count[tiles][:, None]          # (B, L)
    slot = torch.where(valid, bins.start[tiles][:, None] + lanes, 0)
    g = bins.gid[slot]
    px, py = _pixels(tiles, bins.tiles_x, tile, dtype)
    m = scr.means2d[g]
    con = scr.conic[g]
    dx = m[..., 0:1] - px                                        # (B, L, P)
    dy = m[..., 1:2] - py
    power = (-0.5 * (con[..., 0:1] * dx * dx + con[..., 2:3] * dy * dy)
             - con[..., 1:2] * dx * dy)
    alpha = torch.clamp_max(
        scr.opacity[g][..., None] * torch.exp(torch.clamp_max(power, 0.0)),
        ALPHA_MAX)
    keep = (power <= 0) & (alpha >= ALPHA_MIN) & valid[..., None]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    log_t = torch.log1p(-alpha)
    cum = torch.cumsum(log_t, 1)
    live = torch.exp(cum) >= STOP_T            # T after this one stays up
    weight = torch.where(live, alpha * torch.exp(cum - log_t),
                         torch.zeros_like(alpha))
    color = torch.einsum("blp,blc->bpc", weight, scr.rgb[g])
    final_t = torch.exp(torch.where(live, log_t, torch.zeros_like(log_t))
                        .sum(1))
    if counts is not None:
        with torch.no_grad():
            blended = keep & live
            late = keep & ~live
            stop = late & (torch.cumsum(late.int(), 1) == 1)
            visited = blended | stop
            inst = visited.any(2)
            counts["fwd_pairs"] += int(visited.sum())
            counts["blended"] += int(blended.sum())
            k = bins.per_tile
            t32 = ((tiles // bins.tiles_x) // k) * (bins.tiles_x // k) + (
                tiles % bins.tiles_x) // k
            counts["keys"].append((g * (bins.tiles_x * bins.tiles_y)
                                   + t32[:, None])[inst])
    return color + final_t[..., None] * bg.to(dtype)


def _assemble(per_tile: torch.Tensor, bins: Bins, width: int,
              height: int) -> torch.Tensor:
    """(T, P, 3) cell-major pixels -> (3, H, W)."""
    tile = bins.unit
    img = per_tile.reshape(bins.tiles_y, bins.tiles_x, tile, tile, 3)
    img = img.permute(4, 0, 2, 1, 3).reshape(
        3, bins.tiles_y * tile, bins.tiles_x * tile)
    return img[:, :height, :width]


def _per_tile(img: torch.Tensor, bins: Bins) -> torch.Tensor:
    """(3, H, W) -> (T, P, 3), zero past the image's edge."""
    tile = bins.unit
    h, w = img.shape[1:]
    pad = torch.zeros((3, bins.tiles_y * tile, bins.tiles_x * tile),
                      dtype=img.dtype, device=img.device)
    pad[:, :h, :w] = img
    return pad.reshape(3, bins.tiles_y, tile, bins.tiles_x, tile).permute(
        1, 3, 2, 4, 0).reshape(bins.tiles_y * bins.tiles_x, tile * tile, 3)


def render(cloud: dict, cam, sh_degree: int, bg: torch.Tensor, tile: int,
           dtype=torch.float32, counts: bool = False,
           pair_budget: int = PAIR_BUDGET, sub: int = SUB):
    """(image (3, H, W) detached, screen, bins[, counts]).

    ``counts``: {"pixels", "fwd_pairs" (per pixel, the Gaussians with
    alpha >= 1/255 up to and including the one that stops it), "blended"
    (those that blend), "instances" ((Gaussian, tile) pairs with a visited
    pixel), "gaussians_needed" (Gaussians with such a pair), "drawn"
    (Gaussians in front of the camera with a non-empty rect)}.
    """
    with torch.no_grad():
        scr = project(cloud, cam, sh_degree, tile, dtype, sub)
        bins = bin_tiles(scr, cam.width, cam.height, tile)
        pix = sub * sub
        out = torch.zeros((bins.tiles_x * bins.tiles_y, pix, 3), dtype=dtype,
                          device=scr.depth.device)
        out[:] = bg.to(dtype)
        c = None
        if counts:
            c = {"fwd_pairs": 0, "blended": 0, "keys": []}
        for tiles, length in _blocks(bins.count, pix, pair_budget):
            out[tiles] = composite_block(scr, bins, tiles, length, bg, c)
        img = _assemble(out, bins, cam.width, cam.height)
    if not counts:
        return img, scr, bins
    keys = torch.unique(torch.cat(c.pop("keys")))
    c["instances"] = int(keys.numel())
    c["gaussians_needed"] = int(torch.unique(
        keys // (bins.tiles_x * bins.tiles_y)).numel())
    c["pixels"] = cam.width * cam.height
    c["drawn"] = int((scr.radius > 0).sum())
    return img, scr, bins, c


def backward_image(cloud: dict, cam, sh_degree: int, bg: torch.Tensor,
                   tile: int, grad_img: torch.Tensor, dtype=torch.float32,
                   pair_budget: int = PAIR_BUDGET, sub: int = SUB) -> dict:
    """{leaf: gradient} of <grad_img, render(cloud)>: the screen-space
    gradients block by block (each block's pixels recomputed under
    autograd), then back through the projection."""
    leaves = {k: v.detach().to(dtype).requires_grad_() for k, v in
              cloud.items()}
    scr = project(leaves, cam, sh_degree, tile, dtype, sub)
    with torch.no_grad():
        bins = bin_tiles(scr, cam.width, cam.height, tile)
    screen = [scr.means2d, scr.conic, scr.opacity, scr.rgb]
    free = [s.detach().requires_grad_() for s in screen]
    fscr = scr._replace(means2d=free[0], conic=free[1], opacity=free[2],
                        rgb=free[3])
    cot = _per_tile(grad_img.to(dtype), bins)
    for tiles, length in _blocks(bins.count, sub * sub, pair_budget):
        part = composite_block(fscr, bins, tiles, length, bg)
        torch.autograd.backward(part, cot[tiles])
    grads = [f.grad if f.grad is not None else torch.zeros_like(f)
             for f in free]
    torch.autograd.backward(screen, grads)
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v))
            for k, v in leaves.items()}


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (3, H, W) images: 11 x 11 Gaussian window, sigma
    1.5, zero padding, C1 = 0.01^2, C2 = 0.03^2."""
    xs = torch.arange(11, dtype=torch.float64) - 5
    w1 = torch.exp(-xs * xs / (2 * 1.5 ** 2))
    w1 = w1 / w1.sum()
    win = (w1[:, None] * w1[None, :]).to(a.dtype).to(a.device)
    win = win.expand(3, 1, 11, 11)

    def blur(x):
        return torch.nn.functional.conv2d(x[None], win, padding=5,
                                          groups=3)[0]

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a * mu_a
    var_b = blur(b * b) - mu_b * mu_b
    cov = blur(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return s.mean()


def loss_fn(img: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2,
            rows: int | None = None) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM). ``rows`` keeps only the first
    rows of both images (a fault the checks must catch)."""
    if rows is not None:
        img, gt = img[:, :rows], gt[:, :rows]
    gt = gt.to(img.dtype)
    return ((1 - lambda_dssim) * (img - gt).abs().mean()
            + lambda_dssim * (1 - ssim(img, gt)))

