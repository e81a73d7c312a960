"""Training-time video frames along the scene's fixed trajectory.

Port of ``utils/video.py``. ``render_video_frames`` renders every video
camera of the scene with a neural path (``neural_loop.RENDER_FNS``) and
writes ``<model>/video/iter_<N>/<mode>/frame_%04d.png`` (modes "rgb",
"depth", "colmap") with ``scene.image_io.write_png``, so no Pillow is
needed; every ``archive_every``-th frame it saves the intermediate tensors
to ``archive_%04d.npz`` under the JAX package's keys ("featuremap",
"denoiser", "aggregation"), which ``readvideo.py`` reads.
``create_video_from_frames`` (cv2) and ``save_depth_histogram``
(matplotlib) import their libraries when called.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from neuralgaussiansplatting_torch.scene.image_io import write_png


def to_uint8(img: np.ndarray) -> np.ndarray:
    """A float32 (3, H, W) image already clipped to [0, 1] -> uint8
    (H, W, 3), truncating as the JAX package does (the multiply in
    float32, then ``astype``)."""
    return (img.transpose(1, 2, 0) * 255).astype(np.uint8)


def render_video_frames(scene, gaussians, net_params, iteration, model_path,
                        sw: int = 2, modes=("rgb",), archive_every: int = 36):
    """Render every video camera with the ``sw`` neural path; write PNG
    frames under <model>/video/iter_<N>/<mode>/ and archive intermediate
    tensors for the inspector GUI every ``archive_every`` frames. Returns
    the frame paths."""
    from neuralgaussiansplatting_torch.train.neural_loop import RENDER_FNS

    cams = scene.get_video_cameras()
    if not cams:
        return []
    render_fn = RENDER_FNS[sw]
    dev = gaussians.params.xyz.device
    outdir = os.path.join(model_path, "video", f"iter_{iteration}")
    frames = []
    for mode in modes:
        os.makedirs(os.path.join(outdir, mode), exist_ok=True)
    for fi, cam in enumerate(cams):
        with torch.no_grad():
            out = render_fn(cam.params(dev), gaussians.params, net_params,
                            alive=gaussians.state.alive)
        for mode in modes:
            if mode == "rgb":
                arr = to_uint8(torch.clamp(out["render"], 0, 1).cpu().numpy())
            elif mode == "depth":
                d = out["depthmap"].cpu().numpy()
                dmax = d.max() if d.max() > 0 else 1.0
                arr = (np.stack([d / dmax] * 3, -1) * 255).astype(np.uint8)
            elif mode == "colmap":
                arr = ((out["colmap"].cpu().numpy() * 0.5 + 0.5)
                       * 255).astype(np.uint8)
            else:
                raise ValueError(mode)
            path = os.path.join(outdir, mode, f"frame_{fi:04d}.png")
            write_png(path, arr)
            frames.append(path)
        if archive_every and fi % archive_every == 0:
            arch = {"featuremap": out["featuremap"].cpu().numpy()}
            if "denoiser" in out:
                arch["denoiser"] = out["denoiser"].cpu().numpy()
            if "aggregation" in out:
                arch["aggregation"] = out["aggregation"].cpu().numpy()
            np.savez_compressed(
                os.path.join(outdir, f"archive_{fi:04d}.npz"), **arch)
    return frames


def create_video_from_frames(frame_dir, output_path, fps: int = 30):
    """PNG frame directory -> mp4 (reference :161-194)."""
    import cv2

    frames = sorted(f for f in os.listdir(frame_dir) if f.endswith(".png"))
    if not frames:
        return None
    first = cv2.imread(os.path.join(frame_dir, frames[0]))
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(
        output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(cv2.imread(os.path.join(frame_dir, f)))
    writer.release()
    return output_path


def save_depth_histogram(depthmap, path, bins: int = 50):
    """Depth distribution plot (reference :196-218)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = np.asarray(depthmap).reshape(-1)
    d = d[d > 0]
    fig, ax = plt.subplots(figsize=(6, 4))
    if len(d):
        ax.hist(d, bins=bins)
    ax.set_xlabel("depth")
    ax.set_ylabel("pixels")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
