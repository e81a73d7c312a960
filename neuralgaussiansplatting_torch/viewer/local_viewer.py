"""Local interactive viewer (OpenCV window, orbit controls).

Port of ``viewer/local_viewer.py``: orbit and zoom about a target with the
keyboard, each frame rendered by ``gaussian_renderer.render``. Keys: a/d
yaw, w/s pitch, q/e zoom, r reset, ESC quit. Without a display (or
without ``cv2``) ``run_viewer`` says so and returns False; the SIBR remote
viewer against the train entry point's ``--ip`` / ``--port`` works there.

    python -m neuralgaussiansplatting_torch.viewer.local_viewer --ply <file>
"""

from __future__ import annotations

import math
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.ops.preprocess import CameraParams


class OrbitCamera:
    def __init__(self, width=960, height=540, fovx_deg=60.0, distance=4.0,
                 target=(0.0, 0.0, 0.0)):
        self.width = width
        self.height = height
        self.fovx = math.radians(fovx_deg)
        self.distance = distance
        self.yaw = 0.0
        self.pitch = 0.3
        self.target = np.asarray(target, np.float64)
        self._initial = (distance, 0.0, 0.3)

    def reset(self):
        self.distance, self.yaw, self.pitch = self._initial

    def params(self, device="cuda") -> CameraParams:
        cp = math.cos(self.pitch)
        pos = self.target + self.distance * np.array(
            [cp * math.cos(self.yaw), cp * math.sin(self.yaw),
             math.sin(self.pitch)])
        fwd = self.target - pos
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        R = np.stack([right, true_up, fwd], axis=1)
        t = -R.T @ pos
        view = proj.get_world_to_view(R, t)
        fovy = proj.focal2fov(proj.fov2focal(self.fovx, self.width),
                              self.height)
        projm = proj.get_projection_matrix(0.01, 100.0, self.fovx, fovy)
        return CameraParams(
            view=view, full_proj=(projm @ view).astype(np.float32),
            campos=pos.astype(np.float32),
            tan_fovx=math.tan(self.fovx / 2), tan_fovy=math.tan(fovy / 2),
            width=self.width, height=self.height, device=device)


def run_viewer(params, alive, sh_degree, settings=None, width=960,
               height=540, bg=(0.0, 0.0, 0.0)) -> bool:
    """Interactive loop on the Gaussians' device; returns False if no GUI
    is available (checked before ``cv2`` is imported)."""
    from neuralgaussiansplatting_torch.utils.image import (_gui_available,
                                                           _to_bgr_u8)
    if not _gui_available():
        print("no GUI available (DISPLAY unset); use the SIBR remote viewer "
              "against train.py's --ip/--port instead")
        return False
    import cv2

    from neuralgaussiansplatting_torch.gaussian_renderer import render
    from neuralgaussiansplatting_torch.ops import rasterize as rast

    settings = settings or rast.RasterizeSettings()
    dev = params.xyz.device
    cam = OrbitCamera(width=width, height=height)
    bg = torch.tensor(bg, dtype=torch.float32, device=dev)
    while True:
        with torch.no_grad():
            img = render(cam.params(dev), params, alive, sh_degree, bg,
                         settings)["render"].cpu().numpy()
        cv2.imshow("NGS viewer", _to_bgr_u8(img))
        key = cv2.waitKey(16) & 0xFF
        if key == 27:
            break
        elif key == ord("a"):
            cam.yaw -= 0.08
        elif key == ord("d"):
            cam.yaw += 0.08
        elif key == ord("w"):
            cam.pitch = min(cam.pitch + 0.06, 1.5)
        elif key == ord("s"):
            cam.pitch = max(cam.pitch - 0.06, -1.5)
        elif key == ord("q"):
            cam.distance *= 0.92
        elif key == ord("e"):
            cam.distance /= 0.92
        elif key == ord("r"):
            cam.reset()
    cv2.destroyAllWindows()
    return True


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--ply", required=True,
                        help="a point_cloud.ply checkpoint")
    parser.add_argument("--width", type=int, default=960)
    parser.add_argument("--height", type=int, default=540)
    args = parser.parse_args(argv)

    from neuralgaussiansplatting_torch import platform_device
    from neuralgaussiansplatting_torch.models.gaussians import GaussianModel
    g = GaussianModel(device=platform_device())
    g.load_ply(args.ply)
    return run_viewer(g.params, g.state.alive, g.active_sh_degree,
                      width=args.width, height=args.height)


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
