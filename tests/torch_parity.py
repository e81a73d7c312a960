"""Shared helpers for the PyTorch port's parity tests.

Inputs are made with numpy and handed to both packages; results come back
as numpy. The JAX side is jitted so each shape compiles once per file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__
from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.ops import preprocess as jpp
from neuralgaussiansplatting_tpu.train import loop as jloop
from neuralgaussiansplatting_tpu.train import optim as joptim
from neuralgaussiansplatting_torch.gaussian_renderer import render as trender
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.models import nets as tnets
from neuralgaussiansplatting_torch.ops import binning as tbin
from neuralgaussiansplatting_torch.ops import preprocess as tpp
from neuralgaussiansplatting_torch.train import loop as tloop
from neuralgaussiansplatting_torch.train import optim as toptim

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


def train_step_inputs(n, capacity, settings):
    """(params, state, cam, gt, bg) of one training step: the JAX demo cloud
    (``n`` points in ``capacity`` slots, 64x64, SH3) with seeded noise on
    its opacities and SH, and as target the port's render of the
    unperturbed cloud with ``settings`` (numpy)."""
    params, state, cam = __graft_entry__._demo_scene(
        n=n, w=64, h=64, seed=2, capacity=capacity, sh_degree=3)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    tp, ts = port_model(params, state)
    with torch.no_grad():
        gt = trender(port_camera(cam), tp, ts.alive, 3, to_torch(bg),
                     settings)["render"].numpy()
    rng = np.random.default_rng(8)
    params = params._replace(
        opacity=params.opacity + jnp.asarray(rng.normal(
            0, 1.0, params.opacity.shape).astype(np.float32)),
        features_dc=params.features_dc + jnp.asarray(rng.normal(
            0, 0.2, params.features_dc.shape).astype(np.float32)),
        features_rest=jnp.asarray(rng.normal(
            0, 0.1, params.features_rest.shape).astype(np.float32)))
    return params, state, cam, gt, bg


def assert_train_step_matches_jax(inputs, jax_settings, port_settings,
                                  spatial=1.5):
    """One ``train_step`` on both packages from ``inputs``
    (``train_step_inputs``), held at tests/test_torch_train.py's gates: loss
    and PSNR to 1e-5, the monitors equal, the gradients (read back from the
    first Adam moment) at the seq gradient gate, every parameter within two
    learning-rate steps and 99 % of each leaf's elements to 1e-5, the
    densification statistics at the gradient gate."""
    params, state, cam, gt, bg = inputs
    opt = joptim.OptimizationParams()
    jtx = joptim.make_optimizer(opt, spatial)
    j_ts = jloop.TrainState(params, state, jtx.init(params), jnp.asarray(0))
    j_ts2, j_m = jloop.train_step(
        j_ts, cam, jnp.asarray(gt), jnp.asarray(bg), tx=jtx, sh_degree=3,
        settings=jax_settings, lambda_dssim=0.2)

    tp, ts = port_model(params, state)
    ttx = toptim.make_optimizer(opt, spatial)
    t_ts = tloop.TrainState(tp, ts, ttx.init(tp), 0)
    t_ts2, t_m = tloop.train_step(
        t_ts, port_camera(cam), to_torch(gt), to_torch(bg), tx=ttx,
        sh_degree=3, settings=port_settings, lambda_dssim=0.2)

    assert t_ts2.step == 1
    np.testing.assert_allclose(t_m["loss"].item(), float(j_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(t_m["psnr"].item(), float(j_m["psnr"]),
                               rtol=1e-5)
    for key in ("num_rendered", "max_per_tile", "aligned_demand", "dropped",
                "culled", "radii_max"):
        assert int(t_m[key]) == int(j_m[key]), key

    # gradients, through the first moment (mu = (1 - b1) g)
    alive = ts.alive.numpy()
    for field, (mu, _, count) in jax_opt_groups(j_ts2.opt_state).items():
        got = t_ts2.opt_state[field].mu.numpy()
        assert t_ts2.opt_state[field].count == count == 1
        assert np.isfinite(got).all()
        assert not got[~alive].any(), field      # dead slots stay still
        scale = np.abs(mu).max() + 1e-12
        np.testing.assert_allclose(got, mu, atol=5e-4 * scale, rtol=5e-3,
                                   err_msg=field)

    lrs = dict(ttx.lrs, xyz=ttx.lrs["xyz"](0))
    for field, a, b in zip(jgm.GaussianParams._fields, j_ts2.params,
                           t_ts2.params):
        a, b = np.asarray(a), b.numpy()
        if field not in lrs:
            np.testing.assert_array_equal(b, a, err_msg=field)
            continue
        lr = lrs[field]
        diff = np.abs(b - a)
        assert diff.max() <= 2 * lr * (1 + 1e-5) + 1e-6 * np.abs(a).max(), \
            field
        agree = (diff <= 1e-5 * np.abs(a) + 1e-7).mean()
        assert agree >= 0.99, (field, agree)

    # densification statistics: the screen-space gradient norm
    j_acc = np.asarray(j_ts2.gstate.xyz_gradient_accum)
    np.testing.assert_allclose(t_ts2.gstate.xyz_gradient_accum.numpy(), j_acc,
                               atol=5e-4 * j_acc.max(), rtol=5e-3)
    np.testing.assert_array_equal(t_ts2.gstate.denom.numpy(),
                                  np.asarray(j_ts2.gstate.denom))
    np.testing.assert_array_equal(t_ts2.gstate.max_radii2d.numpy(),
                                  np.asarray(j_ts2.gstate.max_radii2d))
