"""Image metrics over rendered test sets: the port's ``metrics.py``.

    python -m neuralgaussiansplatting_torch.metrics -m <model> [<model> ...]

For each model directory, SSIM, PSNR and LPIPS of every
``test/<method>/renders/*.png`` against ``gt/`` of the same name (PNGs read
without Pillow, the first three channels over 255 in float32), averaged per
method into ``results.json`` and listed per view in ``per_view.json``, with
the JAX package's keys and layout. LPIPS needs the VGG weights
(``utils/lpips.py``); without them it is ``null`` and the run says so. Runs
on the CUDA device, or on the CPU when ``NGS_PLATFORM=cpu``.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch.scene.image_io import read_png
from neuralgaussiansplatting_torch.utils import losses
from neuralgaussiansplatting_torch.utils.lpips import lpips_fn


def read_images(renders_dir, gt_dir):
    """(renders, gts, names): float32 (3, H, W) arrays in [0, 1] of the
    files in ``renders_dir`` and their namesakes in ``gt_dir``, sorted by
    name."""
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        r = read_png(os.path.join(renders_dir, fname)).astype(
            np.float32) / 255.0
        g = read_png(os.path.join(gt_dir, fname)).astype(np.float32) / 255.0
        renders.append(r[..., :3].transpose(2, 0, 1))
        gts.append(g[..., :3].transpose(2, 0, 1))
        names.append(fname)
    return renders, gts, names


def evaluate(model_paths) -> dict:
    """Score every method under each model's ``test/``; writes the two
    JSON files per model and returns {model: {method: {metric: mean}}}."""
    dev = platform_device()
    lpips = lpips_fn("vgg", device=dev)

    full_dict = {}
    per_view_dict = {}
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full_dict[scene_dir] = {}
        per_view_dict[scene_dir] = {}
        test_dir = Path(scene_dir) / "test"
        for method in sorted(os.listdir(test_dir)):
            print("Method:", method)
            method_dir = test_dir / method
            renders, gts, names = read_images(method_dir / "renders",
                                              method_dir / "gt")
            scores, lpipss = [], []
            with torch.no_grad():
                for r, g in zip(renders, gts):
                    rt = torch.from_numpy(np.ascontiguousarray(r)).to(dev)
                    gt = torch.from_numpy(np.ascontiguousarray(g)).to(dev)
                    scores.append(torch.stack([losses.ssim(rt, gt),
                                               losses.psnr(rt, gt)]))
                    lpipss.append(lpips(rt, gt) if lpips else None)
            ssims, psnrs = (torch.stack(scores).T.tolist() if scores
                            else ([], []))
            print(f"  SSIM : {np.mean(ssims):.7f}")
            print(f"  PSNR : {np.mean(psnrs):.7f}")
            if lpips:
                print(f"  LPIPS: {np.mean(lpipss):.7f}")
            else:
                print("  LPIPS: unavailable (no pretrained VGG weights)")
            full_dict[scene_dir][method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
                "LPIPS": float(np.mean(lpipss)) if lpips else None,
            }
            per_view_dict[scene_dir][method] = {
                "SSIM": dict(zip(names, map(float, ssims))),
                "PSNR": dict(zip(names, map(float, psnrs))),
                "LPIPS": dict(zip(names, lpipss)) if lpips else None,
            }
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full_dict[scene_dir], f, indent=True)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view_dict[scene_dir], f, indent=True)
    return full_dict


def main(argv=None) -> dict:
    parser = ArgumentParser(description="Training script parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+",
                        type=str, default=[])
    args = parser.parse_args(argv)
    return evaluate(args.model_paths)


if __name__ == "__main__":
    main()
