"""Camera matrices, perspective projection and EWA 2D covariance.

Port of ``ops/projection.py``. Matrices are stored untransposed and applied
as ``M @ p``. The camera helpers are host-side numpy; the rest are tensor ops
that run on their inputs' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Camera matrices (host-side numpy, built once per camera)
# ---------------------------------------------------------------------------

def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def get_world_to_view(R: np.ndarray, t: np.ndarray,
                      translate: np.ndarray = np.zeros(3),
                      scale: float = 1.0) -> np.ndarray:
    """World->view 4x4 (applied as M @ p); ``R`` is cam-to-world rotation,
    ``t`` the world-to-cam translation."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def get_projection_matrix(znear: float, zfar: float,
                          fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style z in [0, 1] perspective matrix (applied as M @ p)."""
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


# ---------------------------------------------------------------------------
# Batched point projection (tensor ops)
# ---------------------------------------------------------------------------

def transform_points_4x3(points: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """(N, 3) world points -> (N, 3) view-space points; view is M @ p 4x4."""
    return points @ view[:3, :3].T + view[:3, 3]


def transform_points_4x4(points: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(N, 3) points -> (N, 4) homogeneous transform by 4x4 (M @ p)."""
    return points @ mat[:, :3].T + mat[:, 3]


def project_points(points: torch.Tensor, full_proj: torch.Tensor) -> torch.Tensor:
    """(N, 3) world -> (N, 3) NDC with the +1e-7 w-guard and a 1e-6
    magnitude floor (points on the camera plane would divide by ~0)."""
    p_hom = transform_points_4x4(points, full_proj)
    denom = p_hom[..., 3:4] + 1e-7
    floor = torch.where(denom < 0, -1e-6, 1e-6)
    denom = torch.where(torch.abs(denom) < 1e-6, floor, denom)
    return p_hom[..., :3] / denom


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def compute_cov2d(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    view: torch.Tensor,
    focal_x: float,
    focal_y: float,
    tan_fovx: float,
    tan_fovy: float,
    limit_x: float | None = None,
    limit_y: float | None = None,
) -> torch.Tensor:
    """EWA projection of (N, 3, 3) world covariances to (N, 3) packed 2D
    covariances (cxx, cxy, cyy), with the 1.3*tan_fov frustum clamp and the
    +0.3 px low-pass. ``limit_*`` override the clamp bounds."""
    t = transform_points_4x3(means3d, view)
    # |z| floor far below the 0.2 near-plane cull keeps 1/z^2 finite
    tz = torch.where(torch.abs(t[..., 2]) < 0.01,
                     torch.where(t[..., 2] < 0, -0.01, 0.01), t[..., 2])
    limx = 1.3 * tan_fovx if limit_x is None else limit_x
    limy = 1.3 * tan_fovy if limit_y is None else limit_y
    tx = torch.clamp(t[..., 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[..., 1] / tz, -limy, limy) * tz

    zero = torch.zeros_like(tz)
    J = torch.stack(
        [
            torch.stack([focal_x / tz, zero, -(focal_x * tx) / (tz * tz)], -1),
            torch.stack([zero, focal_y / tz, -(focal_y * ty) / (tz * tz)], -1),
        ],
        dim=-2,
    )  # (N, 2, 3)
    W = view[:3, :3]
    T = J @ W
    cov = T @ cov3d @ T.transpose(-1, -2)
    cxx = cov[..., 0, 0] + 0.3
    cyy = cov[..., 1, 1] + 0.3
    cxy = cov[..., 0, 1]
    return torch.stack([cxx, cxy, cyy], dim=-1)


def conic_and_radius(cov2d: torch.Tensor):
    """Invert packed 2D covariance; 3-sigma pixel radius.

    Returns (conic (N, 3), radius (N,), det (N,)).
    """
    cxx, cxy, cyy = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = cxx * cyy - cxy * cxy
    det_inv = torch.where(det != 0.0, 1.0 / det, 0.0)
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], dim=-1)
    mid = 0.5 * (cxx + cyy)
    # inf - inf of overflown degenerate rows would be NaN: keep it finite
    d2 = mid * mid - det
    d2 = torch.where(torch.isfinite(d2), d2, 0.1)
    disc = torch.sqrt(torch.clamp_min(d2, 0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc)))
    return conic, radius, det


def tile_rect(point_image: torch.Tensor, radius: torch.Tensor,
              tiles_x: int, tiles_y: int, block_x: int, block_y: int,
              radius_y: torch.Tensor | None = None):
    """Tile-space bounding rect of a splat: (rect_min, rect_max) (N, 2)
    int32, exclusive max, clipped to the tile grid."""
    x, y = point_image[..., 0], point_image[..., 1]
    ry = radius if radius_y is None else radius_y

    def clip(v, hi):
        return torch.clamp(torch.floor(v), 0, hi).to(torch.int32)

    rmin_x = clip((x - radius) / block_x, tiles_x)
    rmin_y = clip((y - ry) / block_y, tiles_y)
    rmax_x = clip((x + radius + block_x - 1) / block_x, tiles_x)
    rmax_y = clip((y + ry + block_y - 1) / block_y, tiles_y)
    return (torch.stack([rmin_x, rmin_y], -1), torch.stack([rmax_x, rmax_y], -1))
