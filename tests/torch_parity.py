"""Shared helpers for the PyTorch port's parity tests.

Inputs are made with numpy and handed to both packages; results come back
as numpy. The JAX side is jitted so each shape compiles once per file.
"""

import jax
import numpy as np
import torch

from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.ops import preprocess as jpp
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.models import nets as tnets
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


def neural_cloud(n, capacity, seed, w=16, h=16):
    """(camera, params, state) of the JAX package for a random cloud of
    ``n`` points with ``capacity`` slots, viewed at ``w`` x ``h``."""
    cam = make_camera(W=w, H=h)
    means = random_gaussians(n=n, deg=0, seed=seed)[0]
    params, state = jgm.create_from_pcd(
        means, np.random.default_rng(seed).random((n, 3)), np.zeros((n, 3)),
        0, capacity=capacity)
    return cam, params, state


def port_model(params, state):
    """The JAX package's (params, state) as the port's, on the CPU."""
    return tgm.params_from_numpy(jgm.GaussianParams(*map(np.asarray, params)),
                                 jgm.GaussianState(*map(np.asarray, state)),
                                 device="cpu")


def port_decoder_tree(jax_tree):
    """A tree shaped like the JAX package's decoder variables (weights,
    gradients or Adam moments) as {"<decoder>.<parameter>": array} in the
    port's layouts."""
    out = {}
    for name, tree in jax_tree.items():
        for key, value in tnets.nets_from_flax(
                jax.tree.map(np.asarray, tree)).items():
            out[f"{name}.{key}"] = value.numpy()
    return out


def port_decoders(jax_net_params) -> dict:
    """The port's decoders holding the weights of the JAX package's
    ``init_decoders`` tree (full widths), through ``nets_from_flax``."""
    modules = {"mlp": tnets.FeatureToRGBMLP(), "unet": tnets.UNet(),
               "cnn": tnets.CNN(), "pure_cnn": tnets.PureCNN()}
    for name, module in modules.items():
        module.load_state_dict(tnets.nets_from_flax(
            jax.tree.map(np.asarray, jax_net_params[name])))
    return modules


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
