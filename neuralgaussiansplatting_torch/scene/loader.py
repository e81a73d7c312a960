"""CameraInfo -> Camera loading with the reference resolution policy.

Port of ``scene/loader.py``: ``-r`` in {1, 2, 4, 8} divides the size
(rounded); -1 downscales images wider than 1600 px to 1600; any other value
is a target width (sizes truncated through float division). An alpha channel
becomes a mask multiplied into the ground truth. The resize is Pillow's
BICUBIC (``scene/image_io.resize``).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from neuralgaussiansplatting_torch.scene import image_io
from neuralgaussiansplatting_torch.scene.cameras import Camera, CameraInfo

_WARNED = False
_WARN_LOCK = threading.Lock()


def pil_to_array(image: np.ndarray, resolution) -> np.ndarray:
    """uint8 (H, W, C) resized to ``resolution`` (W, H) -> (C, H, W) float32
    in [0, 1]; the JAX package's ``pil_to_array`` of the same pixels."""
    resized = image_io.resize(image, resolution)
    arr = np.asarray(resized, dtype=np.float32) / 255.0
    return arr.transpose(2, 0, 1)


def load_cam(info: CameraInfo, uid: int, resolution_scale: float = 1.0,
             resolution: int = -1) -> Camera:
    global _WARNED
    orig_h, orig_w = info.image.shape[:2]

    if resolution in (1, 2, 4, 8):
        target = (round(orig_w / (resolution_scale * resolution)),
                  round(orig_h / (resolution_scale * resolution)))
    else:
        if resolution == -1:
            if orig_w > 1600:
                with _WARN_LOCK:
                    if not _WARNED:
                        print("[ INFO ] Encountered quite large input images "
                              "(>1.6K pixels width), rescaling to 1.6K.\n If "
                              "this is not desired, please explicitly "
                              "specify '--resolution/-r' as 1")
                        _WARNED = True
                global_down = orig_w / 1600
            else:
                global_down = 1
        else:
            global_down = orig_w / resolution
        scale = float(global_down) * float(resolution_scale)
        target = (int(orig_w / scale), int(orig_h / scale))

    rgb = pil_to_array(info.image, target)
    gt = np.clip(rgb[:3], 0.0, 1.0)
    if rgb.shape[0] == 4:
        gt = gt * rgb[3:4]  # the alpha channel masks the ground truth

    return Camera(
        uid=uid, colmap_id=info.uid, R=info.R, T=info.T,
        FovX=info.FovX, FovY=info.FovY, image=gt,
        image_name=info.image_name, width=gt.shape[2], height=gt.shape[1],
    )


def camera_list(cam_infos, resolution_scale: float = 1.0, resolution: int = -1):
    """``load_cam`` of each camera, in order. The images are resized on a
    pool of threads (numpy releases the interpreter lock in the resize's
    array operations): a 1920x1080 view takes about a second alone."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(
            lambda item: load_cam(item[1], item[0], resolution_scale,
                                  resolution), enumerate(cam_infos)))
