"""Training losses and image metrics.

Port of ``utils/losses.py``: L1, L2, MSE, PSNR, the windowed SSIM (11x11
Gaussian window, sigma 1.5, zero padding, C1 = 0.01^2, C2 = 0.03^2) and the
0.8 L1 + 0.2 (1 - SSIM) photometric loss, for (C, H, W) images.

The SSIM blur is separable, as in the JAX package: a column pass then a row
pass, here as two grouped ``conv2d`` over the five stacked maps (x, y, x^2,
y^2, xy). On a GPU cuDNN may run a float32 convolution in TF32, or with an
algorithm whose sums depend on the run. The blur's forward and backward
therefore run with ``torch.backends.cudnn.allow_tf32`` False and
``cudnn.deterministic`` True, set around their convolutions only and
restored after them.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from neuralgaussiansplatting_torch.utils import timing


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - gt).mean()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(pred, gt)))


@functools.lru_cache(maxsize=None)
def _gaussian_window_1d(window_size: int, sigma: float,
                        device: torch.device) -> torch.Tensor:
    """The normalised 1D window on ``device``, made once per device: a copy
    from the host on every call would make the step wait on the device."""
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return torch.from_numpy((g / g.sum()).astype(np.float32)).to(device)


@contextlib.contextmanager
def _exact_cudnn():
    """Full float32 and deterministic cuDNN algorithms inside the block."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved


def _blur_passes(maps: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(C, H, W) Gaussian blur with zero padding: a column pass, then a row
    pass, each one grouped convolution with the 1D window ``w``."""
    ws = w.shape[0]
    c = maps.shape[0]
    with _exact_cudnn():
        x = F.conv2d(maps[None], w.view(1, 1, ws, 1).expand(c, 1, ws, 1),
                     padding=(ws // 2, 0), groups=c)
        x = F.conv2d(x, w.view(1, 1, 1, ws).expand(c, 1, 1, ws),
                     padding=(0, ws // 2), groups=c)
    return x[0]


class _Blur(torch.autograd.Function):
    """The blur, differentiable in ``maps``. Each pass is a symmetric
    zero-padded convolution, hence its own adjoint, and the passes act on
    different axes, so the blur's backward is the blur of the cotangent."""

    @staticmethod
    def forward(ctx, maps, w):
        ctx.save_for_backward(w)
        return _blur_passes(maps, w)

    @staticmethod
    def backward(ctx, cot):
        (w,) = ctx.saved_tensors
        return _blur_passes(cot, w), None


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a (C, H, W) pair."""
    window = _gaussian_window_1d(window_size, sigma, img1.device)
    c = img1.shape[0]
    blurred = _Blur.apply(torch.cat([img1, img2, img1 * img1, img2 * img2,
                               img1 * img2]), window)
    mu1, mu2, e11, e22, e12 = blurred.split(c)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                     lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM)."""
    return ((1.0 - lambda_dssim) * l1_loss(pred, gt)
            + lambda_dssim * (1.0 - ssim(pred, gt)))


@functools.lru_cache(maxsize=None)
def _pixel_grid(height: int, width: int, device: torch.device):
    """(H, W, 3) float32 (x, y, 1) of every pixel, made once per size and
    device."""
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=device),
                            torch.arange(width, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([gx, gy, torch.ones_like(gx)], -1)


def _inverse3(a: torch.Tensor) -> torch.Tensor:
    """The inverse of a (3, 3) matrix by its adjugate: tensor operations on
    its device, with nothing read back to the host."""
    r0, r1, r2 = a
    adj = torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                       torch.linalg.cross(r0, r1)], 1)
    return adj / torch.dot(r0, adj[:, 0])


def depth_to_normal(cam, depth: torch.Tensor) -> torch.Tensor:
    """(3, H, W) world normals of the (H, W) depth map of ``cam`` (a
    ``CameraParams``), as 2DGS's ``depth_to_normal``: each pixel unprojected
    along its ray (the projection's focal lengths, the principal point at
    (W / 2, H / 2)) to depth times the ray plus the camera centre, the cross
    product of the central differences along the rows and the columns,
    normalised; zero on the border. The view is rigid, so the projection of
    camera space is full_proj's first columns times the view's rotation
    transposed. Nothing is read back to the host."""
    h, w = depth.shape
    rot_t = cam.view[:3, :3].T
    proj = cam.full_proj[:, :3] @ rot_t
    intr = torch.stack([(w / 2.0) * proj[0] + (w / 2.0) * proj[3],
                        (h / 2.0) * proj[1] + (h / 2.0) * proj[3], proj[3]])
    ray = rot_t @ _inverse3(intr)
    dirs = _pixel_grid(h, w, depth.device) @ ray.T
    pts = depth[..., None] * dirs + cam.campos
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    nrm = F.normalize(torch.cross(dx, dy, dim=-1), dim=-1)
    return F.pad(nrm.permute(2, 0, 1), (1, 1, 1, 1))


def surfel_loss(loss: torch.Tensor, out: dict, cam, lambda_normal: float,
                lambda_dist: float, depth_ratio: float) -> torch.Tensor:
    """``loss`` plus 2D Gaussian Splatting's two regularisers of a surfel
    render ``out`` (``gaussian_renderer.render_surfel``'s maps):
    lambda_dist x the distortion map's mean, then lambda_normal x the mean
    of 1 - n_rendered . n_surf, n_rendered the normal map in world space
    and n_surf ``depth_to_normal`` of the surface depth (the expected depth
    sum / alpha where ``depth_ratio`` is 0, the median depth where it is 1;
    NaN and infinity read as 0) times alpha, detached. A term of weight 0
    is not computed. Span "ngs.surfel_reg"."""
    with timing.span("ngs.surfel_reg"):
        if lambda_dist:
            loss = loss + lambda_dist * out["rend_dist"].mean()
        if lambda_normal:
            alpha = out["rend_alpha"]
            nw = torch.einsum("ji,jhw->ihw", cam.view[:3, :3],
                              out["rend_normal"])
            expected = torch.nan_to_num(out["rend_depth"] / alpha, 0.0, 0.0)
            median = torch.nan_to_num(out["rend_median"], 0.0, 0.0)
            surf = expected * (1 - depth_ratio) + depth_ratio * median
            sn = depth_to_normal(cam, surf) * alpha.detach()
            loss = loss + lambda_normal * (1 - (nw * sn).sum(0)).mean()
        return loss
