"""Generate a self-contained demo dataset (no external data, no Pillow).

Port of ``tools/make_demo_scene.py``: a NeRF-synthetic-layout scene from a
procedural ground-truth Gaussian mixture. Orbit cameras, GT images rendered
through the port's ``rasterize`` (K1 on the card) and written as straight
(unpremultiplied) RGBA PNGs by ``scene/image_io.write_png``,
``transforms_{train,test}.json``, a ``transforms_video.json`` trajectory
and a subsampled ``points3d.ply`` init cloud; the same flags and the same
seeds as the JAX tool. Then:

    python -m neuralgaussiansplatting_torch.tools.make_demo_scene --out scene
    python -m neuralgaussiansplatting_torch.train -s scene -m out --eval
"""

from __future__ import annotations

import json
import math
import os
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from neuralgaussiansplatting_torch import resolve_device
from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops.preprocess import CameraParams
from neuralgaussiansplatting_torch.ops.sh import RGB2SH
from neuralgaussiansplatting_torch.scene import image_io
from neuralgaussiansplatting_torch.scene import ply as ply_io


def gt_gaussians(n=4000, seed=7):
    """A colorful procedural blob cluster (the JAX tool's draws)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.8, 0.8, (12, 3))
    means = np.concatenate([
        c + rng.normal(0, 0.18, (n // 12, 3)) for c in centers
    ]).astype(np.float32)
    n = means.shape[0]
    scales = rng.uniform(0.01, 0.05, (n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    opac = rng.uniform(0.5, 0.95, n).astype(np.float32)
    hue = (means[:, 0] + means[:, 1] * 0.5 + 1.6) / 3.2
    colors = np.stack([
        0.5 + 0.45 * np.sin(hue * 6.2),
        0.5 + 0.45 * np.sin(hue * 6.2 + 2.1),
        0.5 + 0.45 * np.sin(hue * 6.2 + 4.2),
    ], axis=1).astype(np.float32)
    return means, scales, rot, opac, colors


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--out", default="demo_scene")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--width", type=int, default=0,
                        help="non-square frames; 0 => --size x --size")
    parser.add_argument("--height", type=int, default=0)
    parser.add_argument("--views", type=int, default=24)
    parser.add_argument("--n_gaussians", type=int, default=4000)
    parser.add_argument("--init_points", type=int, default=2000)
    parser.add_argument("--init_noise", type=float, default=0.02,
                        help="init-cloud jitter; the kNN scale init makes "
                             "splat sizes track this")
    parser.add_argument("--gt_scale", type=float, default=1.0,
                        help="multiply GT splat sizes")
    parser.add_argument("--device", default="cuda",
                        help="where the GT images are rendered (cpu: the "
                             "kernels' plain versions)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    means, scales, rot, opac, colors = gt_gaussians(args.n_gaussians)
    if args.gt_scale != 1.0:
        scales = scales * args.gt_scale
    shs = RGB2SH(colors)[:, None, :]
    cap = 1 << max(20, int(np.ceil(np.log2(max(args.n_gaussians * 16, 1)))))
    settings = rast.RasterizeSettings(capacity=cap, max_per_tile=4096,
                                      chunk=128)
    cloud = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (means, scales, rot, opac, shs)]
    bg = torch.zeros(3, device=dev)

    width = args.width or args.size
    height = args.height or args.size
    fovx = math.radians(50.0)
    # square pixels: fovy follows from the aspect ratio, as the loader
    # computes it from camera_angle_x
    fovy = proj.focal2fov(proj.fov2focal(fovx, width), height)
    projm = proj.get_projection_matrix(0.01, 100.0, fovx, fovy)

    def cam_at(ang, elev=0.5, dist=3.6):
        fwd = -np.array([math.cos(ang) * math.cos(elev),
                         math.sin(ang) * math.cos(elev), math.sin(elev)])
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        # the render camera in the renderer's convention (x right, y down,
        # z forward); the OpenGL c2w below flips y and z back
        R = np.stack([right, -true_up, fwd], axis=1)
        pos = -fwd * dist
        view = proj.get_world_to_view(R, -R.T @ pos)
        cp = CameraParams(
            view=view, full_proj=projm @ view,
            campos=pos.astype(np.float32),
            tan_fovx=math.tan(fovx / 2), tan_fovy=math.tan(fovy / 2),
            width=width, height=height, device=dev)
        # OpenGL c2w for the transforms json (x right, y up, z backward)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = true_up
        c2w[:3, 2] = -fwd
        c2w[:3, 3] = pos
        return cp, c2w

    os.makedirs(os.path.join(args.out, "train"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "test"), exist_ok=True)

    # the PNGs are encoded on a pool of threads (zlib and numpy release the
    # interpreter lock) while the next views render
    writes = []
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for split, count, offset in [("train", args.views, 0.0),
                                     ("test", max(args.views // 4, 2), 0.13)]:
            frames = []
            for i in range(count):
                ang = 2 * math.pi * i / count + offset
                elev = 0.35 + 0.3 * math.sin(i * 1.7)
                cp, c2w = cam_at(ang, elev)
                with torch.no_grad():
                    out = rast.rasterize(*cloud, 0, cp, bg, settings)
                img = (torch.clamp(out.color, 0, 1).permute(1, 2, 0)
                       .cpu().numpy())
                alpha_f = 1.0 - out.final_t.cpu().numpy()
                # NeRF-synthetic PNGs store straight colour, which the
                # loader composites over the background; the render is
                # premultiplied over black, so divide the alpha back out
                straight = np.where(
                    alpha_f[..., None] > 1e-6,
                    img / np.maximum(alpha_f[..., None], 1e-6), 0.0)
                arr = (np.clip(straight, 0, 1) * 255).astype(np.uint8)
                alpha = (np.clip(alpha_f, 0, 1) * 255).astype(np.uint8)
                rgba = np.concatenate([arr, alpha[..., None]], axis=-1)
                writes.append(pool.submit(
                    image_io.write_png,
                    os.path.join(args.out, split, f"r_{i}.png"), rgba))
                frames.append({"file_path": f"./{split}/r_{i}",
                               "transform_matrix": c2w.tolist()})
            with open(os.path.join(args.out, f"transforms_{split}.json"),
                      "w") as f:
                json.dump({"camera_angle_x": fovx, "frames": frames}, f,
                          indent=2)
    for w in writes:
        w.result()

    # video trajectory (orbit)
    vframes = []
    for i in range(60):
        _, c2w = cam_at(2 * math.pi * i / 60, 0.45)
        vframes.append({"file_path": f"frame_{i:04d}",
                        "transform_matrix": c2w.tolist()})
    with open(os.path.join(args.out, "transforms_video.json"), "w") as f:
        json.dump({"camera_angle_x": fovx, "frames": vframes}, f, indent=2)

    # init cloud: subsampled noisy ground truth (with replacement when more
    # init points than GT components are requested)
    rng = np.random.default_rng(0)
    idx = rng.choice(len(means), args.init_points,
                     replace=args.init_points > len(means))
    pts = means[idx] + rng.normal(0, args.init_noise,
                                  (args.init_points, 3))
    ply_io.store_point_cloud(os.path.join(args.out, "points3d.ply"),
                             pts, colors[idx])
    print(f"demo scene written to {args.out}/ "
          f"({args.views} train views, {width}x{height})")


if __name__ == "__main__":
    main()
