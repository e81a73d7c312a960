"""Scene orchestrator: dataset detection, camera lists, model init and I/O.

Port of ``scene/scene.py``: a ``sparse/`` folder means COLMAP, a
``transforms_train.json`` Blender; the run's ``input.ply`` and
``cameras.json`` are written as the JAX package writes them; cameras are
shuffled with ``random`` (seed it, e.g. ``utils.general.safe_state``, for
the JAX package's order); ``cameras_extent`` is the nerf++ radius; the model
is saved under ``point_cloud/iteration_N/point_cloud.ply``.
"""

from __future__ import annotations

import json
import os
import random
import shutil

import numpy as np

from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.scene import dataset_readers as readers
from neuralgaussiansplatting_torch.scene import loader


def search_for_max_iteration(folder):
    saved = [int(f.split("_")[-1]) for f in os.listdir(folder)]
    return max(saved)


def camera_to_json(uid, camera):
    rt = np.zeros((4, 4))
    rt[:3, :3] = camera.R.transpose()
    rt[:3, 3] = camera.T
    rt[3, 3] = 1.0
    w2c = np.linalg.inv(rt)
    return {
        "id": uid,
        "img_name": camera.image_name,
        "width": camera.width,
        "height": camera.height,
        "position": w2c[:3, 3].tolist(),
        "rotation": [r.tolist() for r in w2c[:3, :3]],
        "fy": proj.fov2focal(camera.FovY, camera.height),
        "fx": proj.fov2focal(camera.FovX, camera.width),
    }


class Scene:
    """The dataset at ``source_path`` and the model ``gaussians`` made from
    it (or loaded from ``model_path`` at ``load_iteration``, -1 for the
    latest). The Gaussians live on ``gaussians.device``; the cameras'
    images stay on the host until a caller moves them."""

    def __init__(self, source_path: str, model_path: str,
                 gaussians, images: str = "images",
                 resolution: int = -1, white_background: bool = False,
                 eval_split: bool = False, load_iteration: int | None = None,
                 shuffle: bool = True, resolution_scales=(1.0,),
                 capacity: int | None = None):
        self.model_path = model_path
        self.gaussians = gaussians
        self.loaded_iter = None

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(
                    os.path.join(model_path, "point_cloud"))
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        if os.path.exists(os.path.join(source_path, "sparse")):
            scene_info = readers.read_colmap_scene(
                source_path, images, eval_split)
        elif os.path.exists(os.path.join(source_path, "transforms_train.json")):
            print("Found transforms_train.json file, assuming Blender data set!")
            scene_info = readers.read_nerf_synthetic(
                source_path, white_background, eval_split)
        else:
            raise ValueError(f"Could not recognize scene type for {source_path}")

        if not self.loaded_iter and model_path:
            os.makedirs(model_path, exist_ok=True)
            shutil.copyfile(scene_info.ply_path,
                            os.path.join(model_path, "input.ply"))
            all_cams = list(scene_info.train_cameras) + list(scene_info.test_cameras)
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(all_cams)], f)

        if shuffle:
            random.shuffle(scene_info.train_cameras)
            random.shuffle(scene_info.test_cameras)

        self.cameras_extent = scene_info.nerf_normalization["radius"]

        self.train_cameras = {}
        self.test_cameras = {}
        self.video_cameras = {}
        for scale in resolution_scales:
            print("Loading Training Cameras")
            self.train_cameras[scale] = loader.camera_list(
                scene_info.train_cameras, scale, resolution)
            print("Loading Test Cameras")
            self.test_cameras[scale] = loader.camera_list(
                scene_info.test_cameras, scale, resolution)
            print("Loading Video Cameras")
            self.video_cameras[scale] = loader.camera_list(
                scene_info.video_cameras, scale, resolution)

        if self.loaded_iter:
            self.gaussians.load_ply(os.path.join(
                model_path, "point_cloud", f"iteration_{self.loaded_iter}",
                "point_cloud.ply"), capacity)
        else:
            self.gaussians.create_from_pcd(
                scene_info.point_cloud, self.cameras_extent, capacity)

    def save(self, iteration: int):
        out = os.path.join(self.model_path, "point_cloud",
                           f"iteration_{iteration}")
        self.gaussians.save_ply(os.path.join(out, "point_cloud.ply"))

    def get_train_cameras(self, scale=1.0):
        return self.train_cameras[scale]

    def get_test_cameras(self, scale=1.0):
        return self.test_cameras[scale]

    def get_video_cameras(self, scale=1.0):
        return self.video_cameras[scale]
