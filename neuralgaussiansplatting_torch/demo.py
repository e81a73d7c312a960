"""Seeded demo scene: a uniform random cloud in front of one camera.

Builds the same numpy inputs from the same seed as the JAX package's
``__graft_entry__._demo_scene`` (the scene its ``bench.py`` renders), so
both packages build the same scene.
"""

from __future__ import annotations

import math

import numpy as np

from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.ops.preprocess import CameraParams


def demo_camera(w: int, h: int, angle_y: float = 0.0, device="cuda"):
    """The demo camera: 60 degree horizontal fov, 4 units from the origin,
    looking at it; ``angle_y`` (radians) orbits it about the y axis."""
    fovx = math.radians(60.0)
    fovy = proj.focal2fov(proj.fov2focal(fovx, w), h)
    c, s = math.cos(angle_y), math.sin(angle_y)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])  # cam-to-world
    cam_pos = R @ np.array([0.0, 0.0, -4.0])
    view = proj.get_world_to_view(R, -R.T @ cam_pos)
    projm = proj.get_projection_matrix(0.01, 100.0, fovx, fovy)
    return CameraParams(
        view=view, full_proj=projm @ view,
        campos=cam_pos.astype(np.float32),
        tan_fovx=math.tan(fovx / 2), tan_fovy=math.tan(fovy / 2),
        width=w, height=h, device=device)


def demo_scene(n: int = 4096, w: int = 256, h: int = 256, seed: int = 0,
               sh_degree: int = 2, capacity: int | None = None,
               device="cuda"):
    """(params, state, cam) of ``n`` random points in [-1.2, 1.2]^3 with
    random colours, viewed from (0, 0, -4) at ``w`` x ``h``."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    params, state = gm.create_from_pcd(
        pts, rng.random((n, 3)), np.zeros((n, 3)), sh_degree,
        capacity=capacity or n, device=device)
    return params, state, demo_camera(w, h, device=device)
