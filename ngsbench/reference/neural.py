"""Plain neural-feature training steps in PyTorch: the fork's ``trainn.py``
with ``--sw 2`` (its ``render2``), on frozen geometry.

The rules are those of the fork's ``rasterizer2`` and ``utils/net_utils.py``
(github.com/Augustine-2049/NeuralGaussianSplatting):

- z-buffer: every Gaussian is a point; its view depth z is the third row
  of the view transform, its pixel centre the projection (w guarded by
  +1e-7 and a 1e-6 magnitude floor) mapped by ((ndc + 1) size - 1) / 2.
  It is drawn when z > 0.2 and its centre pixel (truncated toward zero)
  is on screen; it covers the pixel rect [trunc(max(x - S/z, 0)),
  trunc(min(x + S/z + 1, W))) by the same in y, S px x depth (3). Each
  pixel takes the nearest point that covers it, the lower id on equal
  depths;
- feature map, C channels a pixel (the features' count, 64): the winner's
  depth, the sin/cos encoding of its unit view direction (dims x, y, z,
  each at frequencies 2^f pi for f < F (4), sin then cos), and its
  features from 1 + 6F on; zero where no point covers the pixel;
- decoders, on the (1, C, H, W) map: a UNet of L levels (3: 3x3 double
  convolutions with ReLUs at B, 2B, ... channels (B = 64), 2x2 max
  pooling, 2x2 stride-2 transposed convolutions, skips by concatenation,
  a 1x1 convolution to RGB) and a CNN (k x k convolutions with ReLUs
  between, 64 -> 100 -> 81 at k = 5, each padded by k // 2), then the
  denoiser: each pixel's K x K window (9) of the reflect-padded UNet image
  weighted by its K^2 CNN outputs (tap ky * K + kx);
- loss (1 - 0.2) L1 + 0.2 (1 - SSIM) (11 x 11 Gaussian window, sigma 1.5,
  zero padding), gradients by autograd to the features and every decoder
  weight, Adam (betas 0.9, 0.999, eps 1e-15, bias-corrected) at one rate.

The decoders' widths are those of the weights handed in; ``decoder_shapes``
gives every weight's shape from a configuration's widths, and ``settings``
the steps' other numbers from its keys.

Written from those rules alone: it shares no code with the program. It
computes in float32 with TF32 off; a control asks for the decoders in
``dtype`` (parameters float32, every layer computed in ``dtype``, outputs
cast back, as mixed precision runs them) or for the depths rounded to
``zbuffer_dtype`` before they are compared. Decoder parameters are keyed
"<decoder>.<layer path>.<weight|bias>" in PyTorch's layouts (a transposed
convolution's weight is (in, out, kh, kw)); the render uses the "unet."
and "cnn." ones and the others get no gradient.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

POINT_SIZE = 3.0
NEAR = 0.2
FREQUENCIES = 4
CHANNELS = 64
TILE = 32                   # the tile of K3's counts
B1, B2, EPS = 0.9, 0.999, 1e-15
KEY_NONE = (1 << 63) - 1
KERNEL = 9                  # the denoiser's window


def decoder_shapes(channels: int = CHANNELS, base: int = 64,
                   levels: int = 3, cnn=(CHANNELS, 100, KERNEL * KERNEL),
                   cnn_kernel: int = 5, out: int = 3) -> dict:
    """{name: shape} of the UNet's and the CNN's parameters in PyTorch's
    layouts: the encoder's double convolutions "DoubleConv_0" to
    "DoubleConv_<levels - 1>", then per level up the transposed
    convolution "ConvTranspose_<j>" and the decoder's double convolution
    "DoubleConv_<levels + j>", then the 1x1 "Conv_0"; the CNN's
    "Conv_<i>"."""
    shapes = {}

    def conv(name, cin, cout, k):
        shapes[name + ".weight"] = (cout, cin, k, k)
        shapes[name + ".bias"] = (cout,)

    def double(name, cin, cout):
        conv(name + ".Conv_0", cin, cout, 3)
        conv(name + ".Conv_1", cout, cout, 3)

    cin = channels
    for i in range(levels):
        double(f"unet.DoubleConv_{i}", cin, base << i)
        cin = base << i
    for j in range(levels - 1):
        width = base << (levels - 2 - j)
        shapes[f"unet.ConvTranspose_{j}.weight"] = (2 * width, width, 2, 2)
        shapes[f"unet.ConvTranspose_{j}.bias"] = (width,)
        double(f"unet.DoubleConv_{levels + j}", 2 * width, width)
    conv("unet.Conv_0", base, out, 1)
    for i, (a, b) in enumerate(zip(cnn[:-1], cnn[1:])):
        conv(f"cnn.Conv_{i}", a, b, cnn_kernel)
    return shapes


def settings(cfg: dict) -> dict:
    """``steps``' keyword arguments from a configuration's keys, with
    ``decoder_shapes``' under "shapes"."""
    freqs, kernel = cfg["pe_frequencies"], cfg["denoiser_kernel"]
    cnn = tuple(cfg["cnn_channels"])
    if cfg["pe_dims"] != 6 * freqs or cnn[-1] != kernel * kernel \
            or cnn[0] != cfg["num_features"]:
        raise ValueError("pe_dims, cnn_channels and denoiser_kernel "
                         "disagree")
    return {"lr": cfg["feature_lr"], "lambda_dssim": cfg["lambda_dssim"],
            "eps": cfg["adam_eps"], "point_size": cfg["point_size"],
            "frequencies": freqs, "kernel": kernel,
            "levels": cfg["unet_levels"],
            "shapes": decoder_shapes(cfg["num_features"],
                                     cfg["unet_base_channels"],
                                     cfg["unet_levels"], cnn,
                                     cfg["cnn_kernel"])}


def no_tf32():
    """Turn TF32 off for matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _camera(cam, device):
    view = torch.as_tensor(cam.view, device=device).float()
    full = torch.as_tensor(cam.full_proj, device=device).float()
    campos = torch.as_tensor(cam.campos, device=device).float()
    return view, full, campos


def footprints(xyz: torch.Tensor, cam, point_size: float = POINT_SIZE):
    """(depth, x0, y0, x1, y1, drawn): each point's view depth, its pixel
    rect (int64, x1 and y1 exclusive) and whether it is drawn."""
    view, full, _ = _camera(cam, xyz.device)
    w, h = cam.width, cam.height
    depth = (xyz @ view[:3, :3].T + view[:3, 3])[:, 2]
    hom = xyz @ full[:, :3].T + full[:, 3]
    wh = hom[:, 3:4] + 1e-7
    wh = torch.where(wh.abs() < 1e-6,
                     torch.where(wh < 0, -1e-6, 1e-6), wh)
    ndc = hom[:, :2] / wh
    x = ((ndc[:, 0] + 1.0) * w - 1.0) * 0.5
    y = ((ndc[:, 1] + 1.0) * h - 1.0) * 0.5
    r = point_size / depth
    x0 = torch.clamp_min(x - r, 0.0).to(torch.int32).long()
    y0 = torch.clamp_min(y - r, 0.0).to(torch.int32).long()
    x1 = torch.clamp_max(x + r + 1.0, float(w)).to(torch.int32).long()
    y1 = torch.clamp_max(y + r + 1.0, float(h)).to(torch.int32).long()
    cx, cy = x.to(torch.int32), y.to(torch.int32)
    drawn = ((depth > NEAR) & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
             & (x1 > x0) & (y1 > y0))
    return depth, x0, y0, x1, y1, drawn


def zbuffer(xyz: torch.Tensor, cam, zbuffer_dtype=torch.float32,
            point_size: float = POINT_SIZE):
    """The nearest point of every pixel.

    Returns (idx (H*W,) int64, -1 where no point covers the pixel; the
    points' depths as compared, float32; counts): every covered (point,
    pixel) pair is a candidate, and each pixel keeps the least key depth
    bits << 32 | id (drawn depths are positive, so their bits order as the
    floats do). ``counts`` holds what K3's bound needs: "pairs" (covered
    (point, pixel) pairs), "instances" ((point, 32 x 32 tile) pairs of the
    drawn points' rects), "tiles" and "pixels"."""
    xyz = xyz.detach().float()
    w, h = cam.width, cam.height
    depth, x0, y0, x1, y1, drawn = footprints(xyz, cam, point_size)
    depth = depth.to(zbuffer_dtype).float().contiguous()
    ids = torch.nonzero(drawn)[:, 0]
    rw, rh = (x1 - x0)[ids], (y1 - y0)[ids]
    per = rw * rh
    total = int(per.sum())
    row = torch.repeat_interleave(torch.arange(ids.shape[0],
                                               device=xyz.device), per)
    local = (torch.arange(total, device=xyz.device)
             - torch.repeat_interleave(torch.cumsum(per, 0) - per, per))
    owner = ids[row]
    pixel = ((y0[owner] + local // rw[row]) * w + x0[owner]
             + local % rw[row])
    key = (depth.view(torch.int32).long()[owner] << 32) | owner
    best = torch.full((w * h,), KEY_NONE, dtype=torch.long,
                      device=xyz.device)
    best = best.scatter_reduce(0, pixel, key, "amin")
    idx = torch.where(best == KEY_NONE, -1, best & 0xFFFFFFFF)
    tx = (x1 - 1) // TILE - x0 // TILE + 1
    ty = (y1 - 1) // TILE - y0 // TILE + 1
    tiles = (-(-w // TILE)) * (-(-h // TILE))
    counts = {"pairs": total, "instances": int((tx * ty)[ids].sum()),
              "tiles": tiles, "pixels": w * h}
    return idx, depth, counts


def feature_map(xyz, features, cam, idx, depth,
                frequencies: int = FREQUENCIES) -> torch.Tensor:
    """(1, C, H, W): per pixel the winner's depth, view-direction
    encoding and features from 1 + 6 ``frequencies`` on (25-63);
    differentiable in ``features``."""
    _, _, campos = _camera(cam, xyz.device)
    hit = idx >= 0
    g = idx.clamp_min(0)
    dirs = xyz.detach().float()[g] - campos
    dirs = dirs / torch.sqrt((dirs * dirs).sum(1, keepdim=True))
    freqs = (2.0 ** torch.arange(frequencies, device=xyz.device)) * math.pi
    scaled = dirs[:, :, None] * freqs
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], -1)
    fmap = torch.cat([depth[g][:, None], enc.reshape(-1, 6 * frequencies),
                      features[g, 1 + 6 * frequencies:]], 1)
    fmap = torch.where(hit[:, None], fmap, 0.0)
    return fmap.T.reshape(1, features.shape[1], cam.height, cam.width)


def _conv(x, p, name, dtype):
    w = p[name + ".weight"]
    return F.conv2d(x.to(dtype), w.to(dtype), p[name + ".bias"].to(dtype),
                    padding=w.shape[-1] // 2)


def _double(x, p, name, dtype):
    x = F.relu(_conv(x, p, name + ".Conv_0", dtype))
    return F.relu(_conv(x, p, name + ".Conv_1", dtype))


def _up(x, p, name, dtype):
    return F.conv_transpose2d(x.to(dtype), p[name + ".weight"].to(dtype),
                              p[name + ".bias"].to(dtype), stride=2)


def unet(x, p, dtype=torch.float32, levels: int = 3) -> torch.Tensor:
    """(1, C, H, W) -> (1, 3, H, W) float32; H and W multiples of
    2^(levels - 1)."""
    skips = [_double(x, p, "unet.DoubleConv_0", dtype)]
    for i in range(1, levels):
        skips.append(_double(F.max_pool2d(skips[-1], 2), p,
                             f"unet.DoubleConv_{i}", dtype))
    d = skips.pop()
    for j in range(levels - 1):
        d = _double(torch.cat([_up(d, p, f"unet.ConvTranspose_{j}", dtype),
                               skips.pop()], 1), p,
                    f"unet.DoubleConv_{levels + j}", dtype)
    return _conv(d, p, "unet.Conv_0", dtype).float()


def cnn(x, p, dtype=torch.float32) -> torch.Tensor:
    """(1, C, H, W) -> (1, K^2, H, W) float32 per-pixel kernels."""
    i = 0
    while f"cnn.Conv_{i + 1}.weight" in p:
        x = F.relu(_conv(x, p, f"cnn.Conv_{i}", dtype))
        i += 1
    return _conv(x, p, f"cnn.Conv_{i}", dtype).float()


def denoise(img: torch.Tensor, kernels: torch.Tensor, k: int = KERNEL):
    """(1, 3, H, W) image, (1, k*k, H, W) kernels -> (3, H, W)."""
    _, c, h, w = img.shape
    if kernels.shape[1] != k * k:
        raise ValueError(f"{kernels.shape[1]} kernel taps for a {k} x {k} "
                         "window")
    padded = F.pad(img, (k // 2,) * 4, mode="reflect")
    windows = F.unfold(padded, k).reshape(c, k * k, h, w)
    return (windows * kernels[0][None]).sum(1)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (3, H, W) images: 11 x 11 Gaussian window, sigma
    1.5, zero padding, C1 = 0.01^2, C2 = 0.03^2."""
    xs = torch.arange(11, dtype=torch.float64) - 5
    w1 = torch.exp(-xs * xs / (2 * 1.5 ** 2))
    w1 = w1 / w1.sum()
    win = (w1[:, None] * w1[None, :]).to(a.dtype).to(a.device)
    win = win.expand(3, 1, 11, 11)

    def blur(x):
        return F.conv2d(x[None], win, padding=5, groups=3)[0]

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a * mu_a
    var_b = blur(b * b) - mu_b * mu_b
    cov = blur(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return s.mean()


def loss_fn(img, gt, lambda_dssim: float = 0.2, rows: int | None = None):
    """(1 - lambda) L1 + lambda (1 - SSIM) of two (3, H, W) images.
    ``rows`` keeps only the first rows of both (a fault the checks must
    catch)."""
    if rows is not None:
        img, gt = img[:, :rows], gt[:, :rows]
    return ((1 - lambda_dssim) * (img - gt).abs().mean()
            + lambda_dssim * (1 - ssim(img, gt)))


def render(xyz, features, decoders, cam, dtype=torch.float32,
           zbuffer_dtype=torch.float32, point_size: float = POINT_SIZE,
           frequencies: int = FREQUENCIES, kernel: int = KERNEL,
           levels: int = 3):
    """(image (3, H, W), idx, counts) of one view."""
    idx, depth, counts = zbuffer(xyz, cam, zbuffer_dtype, point_size)
    x = feature_map(xyz, features, cam, idx, depth, frequencies)
    return denoise(unet(x, decoders, dtype, levels),
                   cnn(x, decoders, dtype), kernel), idx, counts


def steps(xyz, features, decoders: dict, cams, gts, lr: float = 0.0025,
          lambda_dssim: float = 0.2, dtype=torch.float32,
          zbuffer_dtype=torch.float32, loss_rows: int | None = None,
          eps: float = EPS, shapes: dict | None = None, **render_kw):
    """Train ``features`` (N, 64) and ``decoders`` ({name: tensor}) one
    step per camera of ``cams`` against ``gts`` ((3, H, W) each); the
    geometry ``xyz`` stays as it is.

    Returns {"loss": [per step], "grad": {leaf: the first step's
    gradient}, "grad_norm": {leaf: its norm}, "change_norm": {leaf: norm
    of the change over all the steps}, "idx": [per step, the z-buffer's
    winners], "counts": [per step, ``zbuffer``'s counts], "params": {leaf:
    after the steps}}; the leaves are "features" and every decoder
    parameter, and those the render does not use get zero gradients.
    ``shapes`` ({name: shape}, ``decoder_shapes``), where given, must be
    those of the decoders' "unet." and "cnn." parameters; ``render_kw``
    goes to ``render``."""
    start = {"features": features.detach().float()}
    start |= {k: v.detach().float() for k, v in decoders.items()}
    params = {k: v.clone() for k, v in start.items()}
    used = [k for k in params if k == "features"
            or k.startswith(("unet.", "cnn."))]
    if shapes is not None and {k: tuple(params[k].shape) for k in used
                               if k != "features"} != shapes:
        raise ValueError("the decoders' shapes are not the widths'")
    moments = {k: (torch.zeros_like(params[k]), torch.zeros_like(params[k]))
               for k in used}
    losses, idxs, counts, first = [], [], [], None
    for i, (cam, gt) in enumerate(zip(cams, gts)):
        leaves = {k: params[k].clone().requires_grad_() for k in used}
        img, idx, c = render(xyz, leaves["features"], leaves, cam, dtype,
                             zbuffer_dtype, **render_kw)
        loss = loss_fn(img, gt.float(), lambda_dssim, loss_rows)
        grads = dict(zip(used, torch.autograd.grad(loss, list(
            leaves.values()))))
        if i == 0:
            first = {k: grads[k] if k in grads else torch.zeros_like(v)
                     for k, v in params.items()}
        t = i + 1
        for k, g in grads.items():
            m, v = moments[k]
            m = B1 * m + (1 - B1) * g
            v = B2 * v + (1 - B2) * g * g
            moments[k] = (m, v)
            step = (m / (1 - B1 ** t)) / (torch.sqrt(v / (1 - B2 ** t))
                                          + eps)
            params[k] = params[k] - lr * step
        losses.append(float(loss.detach()))
        idxs.append(idx)
        counts.append(c)
        del leaves, img, loss, grads
    change = {k: float((params[k] - start[k]).norm()) for k in params}
    return {"loss": losses, "grad": first,
            "grad_norm": {k: float(g.norm()) for k, g in first.items()},
            "change_norm": change, "idx": idxs, "counts": counts,
            "params": params}


def mismatch(prog_idx: list, ref_idx: list) -> float:
    """The largest share, over the views, of pixels whose winner differs
    from the reference's."""
    return max(float((p.reshape(-1).long() != r.reshape(-1)).float().mean())
               for p, r in zip(prog_idx, ref_idx))
