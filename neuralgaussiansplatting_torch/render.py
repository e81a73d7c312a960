"""Offline rendering of a trained model: the port's ``render.py``.

    python -m neuralgaussiansplatting_torch.render -m <model> \\
        [--iteration N] [--skip_train] [--skip_test] [--backend seq|pallas]

Loads ``point_cloud/iteration_N`` (``--iteration -1``, the default, is the
latest) with the dataset and settings of the model's ``cfg_args`` merged
under the command line, renders every train and test camera with
``gaussian_renderer.render`` (K1 on the default seq backend, K4 on pallas)
and writes ``<model>/<split>/ours_<N>/renders/%05d.png`` and the ground
truth beside them in ``gt/``, without Pillow (``scene.image_io``). Runs on
the CUDA device, or on the CPU when ``NGS_PLATFORM=cpu``.

A render that drops instances (buffers too small for the view) is a wrong
image: the largest ``dropped`` of each split is printed, with a warning
that names the buffer exceeded (``--capacity`` or ``--max_per_tile``) when
it is not 0, and returned by ``main(argv)`` with the split's view count,
seconds and largest demands.
"""

from __future__ import annotations

import os
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from neuralgaussiansplatting_torch import config, platform_device
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models.gaussians import GaussianModel
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.scene import Scene
from neuralgaussiansplatting_torch.scene.image_io import write_png
from neuralgaussiansplatting_torch.utils.video import to_uint8


MONITORS = ("dropped", "num_rendered", "max_per_tile")


def render_set(model_path, name, iteration, views, params, alive, sh_degree,
               bg, settings) -> dict:
    """Render ``views`` and write their PNGs and ground truth; returns the
    largest of each binning monitor over the renders (instances dropped,
    instances rendered, the densest tile's load) and ``png_s``, the host
    seconds spent converting and writing the PNGs."""
    render_path = os.path.join(model_path, name, f"ours_{iteration}",
                               "renders")
    gts_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gts_path, exist_ok=True)

    monitors, png_s = [], 0.0
    for idx, view in enumerate(views):
        with torch.no_grad():
            out = render(view.params(params.xyz.device), params, alive,
                         sh_degree, bg, settings)
        monitors.append(torch.stack([out[k] for k in MONITORS]))
        img = torch.clamp(out["render"], 0, 1).cpu().numpy()
        t0 = time.perf_counter()
        write_png(os.path.join(render_path, f"{idx:05d}.png"), to_uint8(img))
        write_png(os.path.join(gts_path, f"{idx:05d}.png"),
                  to_uint8(np.asarray(view.image)))
        png_s += time.perf_counter() - t0
    largest = (torch.stack(monitors).amax(dim=0).tolist() if monitors
               else [0] * len(MONITORS))
    return {**dict(zip(MONITORS, largest)), "png_s": png_s}


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Testing script parameters")
    config.add_group(parser, config.ModelParams, fill_none=True)
    config.add_group(parser, config.PipelineParams, fill_none=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    return parser


def main(argv=None) -> dict:
    args = config.get_combined_args(build_parser(), argv)
    print("Rendering " + args.model_path)
    device = platform_device()
    dataset = config.extract(config.ModelParams, args)
    pipe = config.extract(config.PipelineParams, args)

    gaussians = GaussianModel(dataset.sh_degree, device=device)
    scene = Scene(dataset.source_path, dataset.model_path, gaussians,
                  images=dataset.images, resolution=dataset.resolution,
                  white_background=dataset.white_background,
                  eval_split=dataset.eval,
                  load_iteration=args.iteration, shuffle=False)
    bg = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background
                      else [0.0, 0.0, 0.0], device=device)
    settings = rast.make_settings(
        pipe.backend, capacity=pipe.capacity, max_per_tile=pipe.max_per_tile,
        expand=pipe.expand, dense_cap=pipe.dense_cap,
        precise_cull=pipe.precise_cull, fast_sort=pipe.fast_sort)

    summary = {"iteration": scene.loaded_iter, "splits": {}}
    for name, skip, views in (("train", args.skip_train,
                               scene.get_train_cameras()),
                              ("test", args.skip_test,
                               scene.get_test_cameras())):
        if skip:
            continue
        t0 = time.perf_counter()
        largest = render_set(dataset.model_path, name, scene.loaded_iter,
                             views, gaussians.params, gaussians.state.alive,
                             gaussians.active_sh_degree, bg, settings)
        seconds = time.perf_counter() - t0
        summary["splits"][name] = {"views": len(views), "seconds": seconds,
                                   **largest}
        print(f"{name}: {len(views)} views in {seconds:.2f} s, largest "
              f"dropped {largest['dropped']}")
        if largest["dropped"]:
            print(f"[warn] {name}: renders dropped up to "
                  f"{largest['dropped']} instances, so those images miss "
                  f"contributors: the densest tile holds "
                  f"{largest['max_per_tile']} instances (--max_per_tile "
                  f"{settings.max_per_tile}), a view up to "
                  f"{largest['num_rendered']} (--capacity "
                  f"{settings.capacity}); raise the one exceeded",
                  file=sys.stderr)
    summary["dropped"] = max(
        (s["dropped"] for s in summary["splits"].values()), default=0)
    return summary


if __name__ == "__main__":
    main()
