"""Camera containers: host-side numpy, turned into the renderer's
``CameraParams`` on a device.

Port of ``scene/cameras.py``. ``CameraInfo.image`` is the file's pixels as
a uint8 (H, W, C) array (``scene/image_io.py``) where the JAX package keeps
a PIL image; ``Camera.image`` is the (C, H, W) float32 ground truth.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.ops.preprocess import CameraParams


@dataclasses.dataclass
class CameraInfo:
    """Raw per-view record produced by dataset readers."""

    uid: int
    R: np.ndarray            # (3,3) cam-to-world rotation
    T: np.ndarray            # (3,) world-to-cam translation
    FovX: float
    FovY: float
    image: np.ndarray        # uint8 (H, W, C)
    image_path: str
    image_name: str
    width: int
    height: int


@dataclasses.dataclass
class Camera:
    """A loaded training/eval camera with its (resized) ground-truth image."""

    uid: int
    colmap_id: int
    R: np.ndarray
    T: np.ndarray
    FovX: float
    FovY: float
    image: np.ndarray | None      # (C, H, W) float32 in [0, 1], mask applied
    image_name: str
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    def __post_init__(self):
        self.world_view_transform = proj.get_world_to_view(
            self.R, self.T, self.trans, self.scale)
        self.projection_matrix = proj.get_projection_matrix(
            self.znear, self.zfar, self.FovX, self.FovY)
        self.full_proj_transform = (
            self.projection_matrix @ self.world_view_transform).astype(np.float32)
        self.camera_center = np.linalg.inv(
            self.world_view_transform)[:3, 3].astype(np.float32)

    def params(self, device="cuda") -> CameraParams:
        return CameraParams(
            view=self.world_view_transform,
            full_proj=self.full_proj_transform,
            campos=self.camera_center,
            tan_fovx=math.tan(self.FovX * 0.5),
            tan_fovy=math.tan(self.FovY * 0.5),
            width=self.width,
            height=self.height,
            device=device,
        )


def minicam(width, height, fovx, fovy, znear, zfar, world_view_transform,
            full_proj_transform, device="cuda") -> CameraParams:
    """Viewer-protocol camera (reference MiniCam): the matrices arrive
    ready-made; ``znear``/``zfar`` are already inside them."""
    inv = np.linalg.inv(world_view_transform)
    return CameraParams(
        view=np.asarray(world_view_transform, np.float32),
        full_proj=np.asarray(full_proj_transform, np.float32),
        campos=inv[:3, 3].astype(np.float32),
        tan_fovx=math.tan(fovx * 0.5),
        tan_fovy=math.tan(fovy * 0.5),
        width=width,
        height=height,
        device=device,
    )
