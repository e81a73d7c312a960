"""The benchmark's inputs, made from ``--seed``: the cloud, the cameras and
the ground-truth images. Both sides are handed the same tensors.

The cloud's positions are the garden regime's (uniform in a cube, as the
demo cloud of the port's ``tools/bench_garden.garden_cloud``); its other
attributes are a trained scene's, drawn on the device in a few large calls
(``make_cloud``). The cameras follow the demo camera's conventions
(COLMAP axes: x right, y down, z forward; a world-to-view matrix and an
OpenGL-style projection with z in [0, 1], applied as ``M @ p``), placed on
a fixed ellipse that the configuration states; the seed changes only the
order in which a cell visits them, never the set.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

SH_C0 = 0.28209479177387814
ZNEAR, ZFAR = 0.01, 100.0


@dataclasses.dataclass(frozen=True)
class Camera:
    """One view: ``view`` and ``full_proj`` (4, 4) float32, ``campos`` (3,)
    float32, as numpy arrays."""

    view: np.ndarray
    full_proj: np.ndarray
    campos: np.ndarray
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """The generator of one input stream of ``seed`` on ``device``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (1 << 63))


def make_cloud(cfg: dict, seed: int, device) -> dict:
    """{leaf: tensor} of ``cfg["cloud"]`` on ``device``, in the port's flat
    layout (xyz, features_dc, features_rest SH coefficient-major, log
    scaling, wxyz rotation, opacity logit): positions uniform in
    the cube ``box``; per-axis log-scales normal around the log of the mean
    spacing (the cube's side over the cube root of n) plus
    ``log_scale_shift``, deviation ``log_scale_sigma``; uniform unit
    quaternions; opacity logits normal (``opacity_logit_mean``,
    ``opacity_logit_sigma``); DC colours uniform in [0, 1]; SH bands 1-3
    normal with deviation ``sh_rest_sigma``."""
    c = cfg["cloud"]
    n = int(cfg["n_gaussians"])
    k = (int(cfg["sh_degree"]) + 1) ** 2
    g = generator(seed, device, 1)
    lo, hi = c["box"]
    spacing = (hi - lo) / n ** (1.0 / 3.0)

    def normal(shape, mean, sigma):
        return torch.randn(shape, generator=g, device=device) * sigma + mean

    xyz = torch.rand((n, 3), generator=g, device=device) * (hi - lo) + lo
    scaling = normal((n, 3), math.log(spacing) + c["log_scale_shift"],
                     c["log_scale_sigma"])
    rotation = torch.randn((n, 4), generator=g, device=device)
    rotation = rotation / rotation.norm(dim=1, keepdim=True)
    opacity = normal((n, 1), c["opacity_logit_mean"],
                     c["opacity_logit_sigma"])
    colors = torch.rand((n, 3), generator=g, device=device)
    features_dc = (colors - 0.5) / SH_C0
    features_rest = normal((n, 3 * (k - 1)), 0.0, c["sh_rest_sigma"])
    return dict(xyz=xyz, features_dc=features_dc,
                features_rest=features_rest, scaling=scaling,
                rotation=rotation, opacity=opacity)


def look_at(pos, target, down) -> np.ndarray:
    """Cam-to-world rotation (columns x right, y down, z forward) of a
    camera at ``pos`` looking at ``target``, ``down`` the world's down."""
    z = np.asarray(target, np.float64) - np.asarray(pos, np.float64)
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(down, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def projection_matrix(tan_fovx: float, tan_fovy: float) -> np.ndarray:
    p = np.zeros((4, 4), np.float64)
    p[0, 0] = 1.0 / tan_fovx
    p[1, 1] = 1.0 / tan_fovy
    p[3, 2] = 1.0
    p[2, 2] = ZFAR / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return p


def camera(pos, rot, fovx: float, width: int, height: int) -> Camera:
    """The ``Camera`` at ``pos`` with cam-to-world rotation ``rot``."""
    pos = np.asarray(pos, np.float64)
    view = np.eye(4)
    view[:3, :3] = rot.T
    view[:3, 3] = -rot.T @ pos
    tan_fovx = math.tan(fovx / 2)
    focal = width / (2.0 * tan_fovx)
    tan_fovy = height / (2.0 * focal)
    full = projection_matrix(tan_fovx, tan_fovy) @ view
    return Camera(view.astype(np.float32), full.astype(np.float32),
                  pos.astype(np.float32), tan_fovx, tan_fovy, width, height)


def _ellipse(c: dict, angles, fovx, w, h):
    down = (0.0, 1.0, 0.0)
    out = []
    for a in angles:
        pos = (c["semi_axes"][0] * math.sin(a), c["height"],
               -c["semi_axes"][1] * math.cos(a))
        out.append(camera(pos, look_at(pos, c["target"], down), fovx, w, h))
    return out


def cameras(cfg: dict, which: str) -> list:
    """The configuration's "train" or "orbit" cameras, in their fixed
    order.

    ``views`` angles evenly round an ellipse at ``height``; training
    takes those whose index is not a multiple of ``holdout_every`` (the
    3DGS test split); the orbit is ``orbit_views`` angles half a step off
    the training ones.
    """
    c = cfg["cameras"]
    w, h = cfg["width"], cfg["height"]
    if c["kind"] != "ellipse":
        raise ValueError(f"unknown camera kind {c['kind']!r}")
    if which == "train":
        idx = [i for i in range(c["views"]) if i % c["holdout_every"] != 0]
        angles = [2 * math.pi * i / c["views"] for i in idx]
    else:
        m = c["orbit_views"]
        angles = [2 * math.pi * (i + 0.5) / m for i in range(m)]
    return _ellipse(c, angles, c["fovx"], w, h)


def extent(cams) -> float:
    """The nerf++ radius of the camera centres: 1.1 x the largest distance
    from their mean (the scene extent that scales the xyz learning rate)."""
    centers = np.stack([c.campos.astype(np.float64) for c in cams])
    return float(np.linalg.norm(centers - centers.mean(0), axis=1).max()
                 * 1.1)


def make_images(cfg: dict, seed: int, views: int, device,
                chunk: int = 16) -> torch.Tensor:
    """(views, 3, H, W) float32 ground truth in [0, 1]: per view a coarse
    random field (``gt["coarse_px"]`` pixels a cell) upsampled bilinearly,
    plus uniform texture of amplitude ``gt["texture"]``, made ``chunk``
    views at a time."""
    g = generator(seed, device, 2)
    w, h = cfg["width"], cfg["height"]
    cell = cfg["gt"]["coarse_px"]
    amp = cfg["gt"]["texture"]
    out = torch.empty((views, 3, h, w), device=device)
    gh, gw = -(-h // cell) + 1, -(-w // cell) + 1
    for v0 in range(0, views, chunk):
        b = min(chunk, views - v0)
        coarse = torch.rand((b, 3, gh, gw), generator=g, device=device)
        img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                            align_corners=False)
        img.mul_(1.0 - amp).add_(
            torch.rand((b, 3, h, w), generator=g, device=device), alpha=amp)
        out[v0:v0 + b] = img
    return out

