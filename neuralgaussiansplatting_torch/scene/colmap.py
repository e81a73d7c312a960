"""COLMAP sparse-reconstruction parsers (binary and text).

The port's own copy of the JAX package's ``scene/colmap.py``; the bulk
points3D parse goes through the port's ``native`` loader.

Behavioral parity target: reference scene/colmap_loader.py (read_*_binary at
:125/:180/:215, text variants at :83/:156/:236, qvec2rotmat :43-53). Written
against the public COLMAP file-format spec; vectorized with numpy instead of
per-record struct loops where the format allows.
"""

from __future__ import annotations

import collections
import struct

import numpy as np

CameraModel = collections.namedtuple("CameraModel", ["model_id", "model_name", "num_params"])
ColmapCamera = collections.namedtuple("ColmapCamera", ["id", "model", "width", "height", "params"])
ColmapImage = collections.namedtuple(
    "ColmapImage", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    """wxyz quaternion -> 3x3 rotation, reference colmap_loader.py:43-53."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R):
    """3x3 rotation -> wxyz quaternion (largest-eigenvector method)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path):
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read(f, 8 * model.num_params, "d" * model.num_params))
            cams[cid] = ColmapCamera(cid, model.model_name, w, h, params)
    return cams


def read_cameras_text(path):
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            cams[cid] = ColmapCamera(
                cid, parts[1], int(parts[2]), int(parts[3]),
                np.array(tuple(map(float, parts[4:]))),
            )
    return cams


def _read_null_terminated(f):
    name = b""
    while True:
        c = f.read(1)
        if c == b"\x00" or c == b"":
            return name.decode("utf-8")
        name += c


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            (cam_id,) = _read(f, 4, "i")
            name = _read_null_terminated(f)
            (num_pts,) = _read(f, 8, "Q")
            data = np.frombuffer(f.read(24 * num_pts), dtype=np.float64).reshape(-1, 3)
            xys = data[:, :2].copy()
            p3d = data[:, 2].view(np.int64).copy()
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, p3d)
    return images


def read_images_text(path):
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        parts = meta.split()
        iid = int(parts[0])
        qvec = np.array(tuple(map(float, parts[1:5])))
        tvec = np.array(tuple(map(float, parts[5:8])))
        cam_id = int(parts[8])
        name = parts[9]
        vals = np.array(tuple(map(float, pts.split()))).reshape(-1, 3) if pts else np.zeros((0, 3))
        images[iid] = ColmapImage(
            iid, qvec, tvec, cam_id, name, vals[:, :2], vals[:, 2].astype(np.int64)
        )
    return images


def read_points3d_binary(path):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, error (N,) f64).

    Uses the native bulk parser (native/ngs_native.cpp) when loadable — large
    scenes ship hundreds of MB of points — with this Python fallback."""
    from neuralgaussiansplatting_torch import native
    res = native.read_points3d_binary(path)
    if res is not None:
        return res
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            data = _read(f, 43, "QdddBBBd")
            xyzs.append(data[1:4])
            rgbs.append(data[4:7])
            errs.append(data[7])
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, 1)
    return np.array(xyzs), np.array(rgbs, dtype=np.uint8), np.array(errs)


def read_points3d_text(path):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append(tuple(map(float, parts[1:4])))
            rgbs.append(tuple(map(int, parts[4:7])))
            errs.append(float(parts[7]))
    return np.array(xyzs), np.array(rgbs, dtype=np.uint8), np.array(errs)


def read_extrinsics(sparse_dir):
    """Prefer binary, fall back to text (reference dataset_readers.py:152-160)."""
    import os
    b = os.path.join(sparse_dir, "images.bin")
    return read_images_binary(b) if os.path.exists(b) else read_images_text(
        os.path.join(sparse_dir, "images.txt"))


def read_intrinsics(sparse_dir):
    import os
    b = os.path.join(sparse_dir, "cameras.bin")
    return read_cameras_binary(b) if os.path.exists(b) else read_cameras_text(
        os.path.join(sparse_dir, "cameras.txt"))


def read_points3d(sparse_dir):
    import os
    b = os.path.join(sparse_dir, "points3D.bin")
    return read_points3d_binary(b) if os.path.exists(b) else read_points3d_text(
        os.path.join(sparse_dir, "points3D.txt"))
