"""Dataset readers: COLMAP scenes, Blender/NeRF-synthetic transforms, video
camera trajectories.

Port of ``scene/dataset_readers.py``: the same cameras, splits, normalisation
and init clouds (llffhold 8; the OpenGL -> COLMAP axis flip; the alpha
composite over the background; black placeholder frames for missing images
and ``transforms_video.json``; the unseeded 100k-point random cloud when a
Blender scene has no ``points3d.ply``). Images are read by
``scene/image_io.py`` instead of PIL.
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.ops.sh import SH2RGB
from neuralgaussiansplatting_torch.scene import colmap as colmap_io
from neuralgaussiansplatting_torch.scene import image_io
from neuralgaussiansplatting_torch.scene import ply as ply_io
from neuralgaussiansplatting_torch.scene.cameras import CameraInfo


@dataclasses.dataclass
class BasicPointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


@dataclasses.dataclass
class SceneInfo:
    point_cloud: BasicPointCloud | None
    train_cameras: list
    test_cameras: list
    video_cameras: list
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos):
    """Camera-centroid radius * 1.1."""
    centers = []
    for cam in cam_infos:
        w2c = proj.get_world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, axis=0)
    avg = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - avg, axis=1).max()
    return {"translate": -avg, "radius": diagonal * 1.1}


def read_colmap_cameras(extrinsics, intrinsics, images_folder):
    infos = []
    for key in extrinsics:
        extr = extrinsics[key]
        intr = intrinsics[extr.camera_id]
        R = np.transpose(colmap_io.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fovy = proj.focal2fov(intr.params[0], intr.height)
            fovx = proj.focal2fov(intr.params[0], intr.width)
        elif intr.model == "PINHOLE":
            fovy = proj.focal2fov(intr.params[1], intr.height)
            fovx = proj.focal2fov(intr.params[0], intr.width)
        else:
            raise ValueError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE cameras) supported!")
        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, FovX=fovx, FovY=fovy,
            image=image_io.open_image(image_path), image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0],
            width=intr.width, height=intr.height))
    infos.sort(key=lambda c: c.image_name)
    return infos


def read_colmap_scene(path, images="images", eval_split=False, llffhold=8):
    sparse = os.path.join(path, "sparse/0")
    extrinsics = colmap_io.read_extrinsics(sparse)
    intrinsics = colmap_io.read_intrinsics(sparse)
    cam_infos = read_colmap_cameras(
        extrinsics, intrinsics, os.path.join(path, images))

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        xyz, rgb, _ = colmap_io.read_points3d(sparse)
        ply_io.store_point_cloud(ply_path, xyz, rgb)
    try:
        pcd = BasicPointCloud(*ply_io.fetch_point_cloud(ply_path))
    except (OSError, ValueError, KeyError):
        pcd = None
    return SceneInfo(pcd, train, test, [], norm, ply_path)


def read_cameras_from_transforms(path, transformsfile, white_background,
                                 extension=".png", default_width=None,
                                 default_height=None):
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]

    def read_frame(idx, frame):
        file_path = frame["file_path"]
        if not file_path.endswith(extension):
            file_path = file_path + extension
        cam_name = os.path.join(path, file_path)
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        if os.path.exists(cam_name):
            # float64 composite, then truncation to uint8: the JAX
            # package's arithmetic, to the bit
            im = image_io.to_rgba(image_io.open_image(cam_name)) / 255.0
            bg = np.ones(3) if white_background else np.zeros(3)
            arr = im[:, :, :3] * im[:, :, 3:4] + bg * (1 - im[:, :, 3:4])
            image = (arr * 255.0).astype(np.uint8)
            height, width = image.shape[:2]
        else:
            # a black frame for a view without ground truth (video
            # trajectories)
            width = default_width or 800
            height = default_height or 800
            image = np.zeros((height, width, 3), np.uint8)

        fovy = proj.focal2fov(proj.fov2focal(fovx, width), height)
        return CameraInfo(
            uid=idx, R=R, T=T, FovX=fovx, FovY=fovy, image=image,
            image_path=cam_name, image_name=Path(cam_name).stem,
            width=width, height=height)

    # the frames are decoded on a pool of threads (zlib and numpy release
    # the interpreter lock), in order
    frames = contents["frames"]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(read_frame, range(len(frames)), frames))


def read_nerf_synthetic(path, white_background=False, eval_split=False,
                        extension=".png", rng=None):
    train = read_cameras_from_transforms(
        path, "transforms_train.json", white_background, extension)
    test = read_cameras_from_transforms(
        path, "transforms_test.json", white_background, extension)

    video = []
    if os.path.exists(os.path.join(path, "transforms_video.json")):
        dw = train[0].width if train else None
        dh = train[0].height if train else None
        video = read_cameras_from_transforms(
            path, "transforms_video.json", white_background, extension, dw, dh)

    if not eval_split:
        train = train + test
        test = []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        rng = rng or np.random.default_rng()
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        ply_io.store_point_cloud(ply_path, xyz,
                                 SH2RGB(shs).astype(np.float32) * 255)
    try:
        pcd = BasicPointCloud(*ply_io.fetch_point_cloud(ply_path))
    except (OSError, ValueError, KeyError):
        pcd = None
    return SceneInfo(pcd, train, test, video, norm, ply_path)


SCENE_LOAD_CALLBACKS = {
    "Colmap": read_colmap_scene,
    "Blender": read_nerf_synthetic,
}
