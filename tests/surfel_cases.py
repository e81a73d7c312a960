"""Seeded surfels (2D Gaussian Splatting) and a camera for the surfel tests
(``tests/test_torch_surfel.py`` on the CPU, ``tests/test_torch_surfel_cuda.py``
on the card). Imports no JAX."""

from __future__ import annotations

import math

import torch

from ngsbench import scene
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops.preprocess import CameraParams

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def cloud(n: int, seed: int, device="cpu", side: float = 1.6,
          log_scale: float | None = None) -> dict:
    """{leaf: tensor} of ``n`` surfels in a cube of ``side`` round the
    origin: log-scales normal round ``log_scale`` (by default a sixth of
    the mean spacing), uniform rotations, opacity logits N(0, 1.5^2), SH of
    degree 3."""
    g = torch.Generator(device=device).manual_seed(seed)
    if log_scale is None:
        log_scale = math.log(side / n ** (1 / 3) / 6 * 4)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    q = randn(n, 4)
    return {"xyz": rand(n, 3) * side - side / 2,
            "features_dc": randn(n, 3) * 0.5,
            "features_rest": randn(n, 45) * 0.05,
            "scaling": randn(n, 2) * 0.4 + log_scale,
            "rotation": q / q.norm(dim=1, keepdim=True),
            "opacity": randn(n, 1) * 1.5}


def camera(width: int, height: int, pos=(0.3, -0.4, -3.0),
           fovx: float = 1.0) -> scene.Camera:
    """A camera at ``pos`` looking at the origin (the benchmark's
    conventions)."""
    return scene.camera(pos, scene.look_at(pos, (0.0, 0.0, 0.0),
                                           (0.0, 1.0, 0.0)), fovx, width,
                        height)


def port_camera(cam: scene.Camera, device) -> CameraParams:
    return CameraParams(cam.view, cam.full_proj, cam.campos, cam.tan_fovx,
                        cam.tan_fovy, cam.width, cam.height, device=device)


def params(leaves: dict) -> gm.GaussianParams:
    """The port's parameters of ``cloud``'s leaves (normals and neural
    features zero)."""
    n = leaves["xyz"].shape[0]
    z = leaves["xyz"].new_zeros
    return gm.GaussianParams(
        xyz=leaves["xyz"], normals=z((n, 3)),
        features_dc=leaves["features_dc"],
        features_rest=leaves["features_rest"],
        features=z((n, gm.NUM_NEURAL_FEATURES)),
        scaling=leaves["scaling"], rotation=leaves["rotation"],
        opacity=leaves["opacity"])


def model(leaves: dict, extent: float = 2.0) -> gm.GaussianModel:
    """A ``GaussianModel`` holding ``leaves`` with every slot alive and SH
    at degree 3."""
    n = leaves["xyz"].shape[0]
    dev = leaves["xyz"].device
    m = gm.GaussianModel(3, device=dev, surfel=True)
    z = torch.zeros(n, device=dev)
    m.params = params(leaves)
    m.state = gm.GaussianState(torch.ones(n, dtype=torch.bool, device=dev),
                               z, z.clone(), z.clone())
    m.active_sh_degree = 3
    m.spatial_lr_scale = extent
    return m
