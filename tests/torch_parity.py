"""Shared helpers for the PyTorch port's parity tests.

Inputs are made with numpy and handed to both packages; results come back
as numpy. The JAX side is jitted so each shape compiles once per file.
"""

import jax
import numpy as np
import torch

from neuralgaussiansplatting_tpu.ops import preprocess as jpp
from neuralgaussiansplatting_torch.ops import binning as tbin
from neuralgaussiansplatting_torch.ops import preprocess as tpp

from scenes import make_camera, random_gaussians


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


def port_stage_inputs(n, deg, seed, opacity=None, block=32, chunk=128,
                      max_per_tile=1024, **scene):
    """Preprocess + bin on the port (CPU) at 64x64: the (Instances, attrs,
    tiles per side) both packages' blend stages are fed. ``scene`` goes to
    ``random_gaussians``."""
    cam = make_camera(W=64, H=64)
    means, scales, rot, opac, shs = random_gaussians(n=n, deg=deg, seed=seed,
                                                     **scene)
    if opacity is not None:
        opac = np.full_like(opac, opacity)
    pre = tpp.preprocess_gaussians(
        *map(to_torch, (means, scales, rot, opac, shs)), deg,
        port_camera(cam), block, block, tight=True)
    t = 64 // block
    inst = tbin.bin_gaussians(pre, t, t, 1 << 13, max_per_tile, chunk,
                              pack_keys=True, precise_cull=True,
                              block_x=block, block_y=block, width=64,
                              height=64)
    attrs = (pre.means2d, pre.conic, pre.opacity, pre.rgb)
    return inst, attrs, t


def jax_opt_groups(opt_state) -> dict:
    """{GaussianParams field: (mu, nu, count)} of a state of the JAX
    package's ``train.optim.make_optimizer``, as numpy."""
    from neuralgaussiansplatting_tpu.train.optim import PARAM_LABELS
    groups = {}
    for field, label in PARAM_LABELS._asdict().items():
        if label == "frozen":
            continue
        adam = opt_state.inner_states[label].inner_state[0]
        groups[field] = (np.asarray(getattr(adam.mu, field)),
                         np.asarray(getattr(adam.nu, field)),
                         int(adam.count))
    return groups
