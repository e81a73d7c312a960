"""Shared helpers for the PyTorch port's parity tests.

Inputs are made with numpy and handed to both packages; results come back
as numpy. The JAX side is jitted so each shape compiles once per file.
"""

import jax
import numpy as np
import torch

from neuralgaussiansplatting_tpu.ops import preprocess as jpp
from neuralgaussiansplatting_torch.ops import preprocess as tpp

from scenes import random_gaussians


def to_torch(x) -> torch.Tensor:
    """A CPU tensor holding a copy of ``x`` (numpy or JAX array)."""
    return torch.from_numpy(np.array(x))


def tuple_to_torch(nt, cls):
    """A NamedTuple of arrays -> the port's NamedTuple ``cls`` of tensors."""
    return cls(*(to_torch(x) for x in nt))


def port_camera(cam: jpp.CameraParams) -> tpp.CameraParams:
    return tpp.CameraParams(
        np.asarray(cam.view), np.asarray(cam.full_proj),
        np.asarray(cam.campos), cam.tan_fovx, cam.tan_fovy, cam.width,
        cam.height, limit_x=cam.limit_x, limit_y=cam.limit_y, device="cpu")


def scene_inputs(n=250, deg=1, seed=3):
    """``random_gaussians`` plus Gaussians that the cull chain must drop for
    ``make_camera()`` (at (4, 0, 0), looking at the origin): three dead ones
    (opacity 0), three behind the camera and three far outside the frame."""
    means, scales, rot, opac, shs = random_gaussians(n=n, deg=deg, seed=seed)
    opac[0:3] = 0.0
    means[3:6] = [[6.0, 0.1 * i, 0.0] for i in range(3)]
    means[6:9] = [[0.0, 0.0, 30.0 + i] for i in range(3)]
    return means, scales, rot, opac, shs


jax_preprocess = jax.jit(jpp.preprocess_gaussians,
                         static_argnames=("sh_degree", "block_x", "block_y",
                                          "tight"))
