"""The port's neural-feature path vs the JAX package: the feature map and
its gradient, the decoders (weights carried across by ``nets_from_flax``),
the denoiser and ``render1/2/3``, on the same numpy inputs.

Tolerances: the feature map and colmap to atol 1e-6 and the features'
gradient to atol 1e-5 (``tests/test_zbuffer.py``'s gates); each decoder to
rtol 1e-4, atol 1e-5 (float32 convolutions that sum in another order);
``render1/2/3`` are compared in ``tests/test_torch_neural_render.py``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu import gaussian_renderer as jgr
from neuralgaussiansplatting_tpu.models import nets as jnets
from neuralgaussiansplatting_tpu.ops import idxmap as jidx
from neuralgaussiansplatting_tpu.ops import zbuffer_pallas as jz
from neuralgaussiansplatting_torch import gaussian_renderer as tgr
from neuralgaussiansplatting_torch.models import nets as tnets
from neuralgaussiansplatting_torch.ops import denoise as tdn
from neuralgaussiansplatting_torch.ops import idxmap as tidx

from scenes import make_camera, random_gaussians
from torch_parity import port_camera, to_torch

torch.set_num_threads(2)


def test_positional_encoding_matches_jax():
    dirs = np.random.default_rng(0).normal(size=(200, 3)).astype(np.float32)
    want = np.asarray(jidx.positional_encoding_3d(jnp.asarray(dirs)))
    got = tidx.positional_encoding_3d(to_torch(dirs)).numpy()
    assert got.shape == (200, tidx.PE_DIMS)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # dim-major [dim][freq][sin, cos]
    np.testing.assert_allclose(got[:, 8 * 2 + 2 * 3 + 1],
                               np.cos(8 * np.pi * dirs[:, 2]), atol=1e-5)


@pytest.mark.parametrize("backend,w,h,capacity",
                         [("tiled", 64, 64, 1 << 14),
                          ("xla", 96, 48, 1 << 16)])
def test_render_idxmaps_and_feature_gradient_match_jax(backend, w, h,
                                                       capacity, monkeypatch):
    n = 400
    means = random_gaussians(n, seed=11)[0]
    feats = np.random.default_rng(0).normal(size=(n, 64)).astype(np.float32)
    cam = make_camera(w, h)

    def jax_maps(f):
        return jidx.render_idxmaps(jnp.asarray(means), f, cam, capacity,
                                   backend=backend)

    jg = jax.jit(jax.grad(lambda f: jnp.sum(jax_maps(f).featuremap ** 2)))(
        jnp.asarray(feats))
    # The maps come from JAX run eagerly around its jitted z-buffer: under
    # jit XLA fuses the view-direction normalisation and rounds it 1-2 ulp
    # apart, which the 8 pi encoding frequency lifts to ~2e-6.
    monkeypatch.setattr(jz, "compute_idxmap_tiled", jax.jit(
        jz.compute_idxmap_tiled, static_argnames=("capacity",)))
    monkeypatch.setattr(jidx, "compute_idxmap", jax.jit(
        jidx.compute_idxmap, static_argnames=("capacity",)))
    jm = jax_maps(jnp.asarray(feats))

    f = to_torch(feats).requires_grad_()
    tm = tidx.render_idxmaps(to_torch(means), f, port_camera(cam), capacity,
                             backend=backend)
    (tm.featuremap ** 2).sum().backward()

    np.testing.assert_array_equal(tm.idxmap.numpy(), np.asarray(jm.idxmap))
    assert int(tm.num_inst) == int(jm.num_inst)
    for name in ("featuremap", "colmap", "depthmap"):
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(),
                                   np.asarray(getattr(jm, name)), atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jg), atol=1e-5)
    assert not f.grad[:, :tidx.PE_DIMS + 1].any()
    assert f.grad[:, tidx.PE_DIMS + 1:].abs().max() > 0
    assert (tm.idxmap >= 0).float().mean() > 0.05


def test_feature_gather_backward_is_an_exact_sum_that_repeats():
    """The winner-row gather's backward: per Gaussian, the sum of its
    pixels' cotangents (float64 check), nothing for misses, and the same
    bits on a second pass."""
    means = random_gaussians(300, seed=4)[0]
    feats = to_torch(np.random.default_rng(1).normal(
        size=(300, 64)).astype(np.float32))
    cam = port_camera(make_camera(64, 64))
    cot = torch.randn((64, 64, 64), generator=torch.Generator().manual_seed(2))
    grads = []
    for _ in range(2):
        f = feats.clone().requires_grad_()
        maps = tidx.render_idxmaps(to_torch(means), f, cam, 1 << 14)
        (maps.featuremap * cot).sum().backward()
        grads.append(f.grad)
    assert torch.equal(grads[0], grads[1])
    idx = maps.idxmap.reshape(-1).long()
    hit = idx >= 0
    want = torch.zeros((300, 64), dtype=torch.float64).index_add_(
        0, idx[hit], cot.reshape(-1, 64)[hit].double())
    want[:, :tidx.PE_DIMS + 1] = 0
    np.testing.assert_allclose(grads[0].numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


DECODERS = {
    "mlp": (lambda: jnets.FeatureToRGBMLP(hidden_features=16),
            lambda: tnets.FeatureToRGBMLP(hidden_features=16)),
    "unet": (lambda: jnets.UNet(base_channels=8),
             lambda: tnets.UNet(base_channels=8)),
    "small_unet": (lambda: jnets.SmallUNet(base_channels=8),
                   lambda: tnets.SmallUNet(base_channels=8)),
    "cnn": (lambda: jnets.CNN(mid_channels=16),
            lambda: tnets.CNN(mid_channels=16)),
    "pure_cnn": (lambda: jnets.PureCNN(mid_channels=16),
                 lambda: tnets.PureCNN(mid_channels=16)),
}


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoder_matches_flax(name):
    """Each decoder at narrow widths with Flax's weights, on a 16x24 image
    (rows and columns not equal, so a transposed layout would show); the
    UNets check the transposed convolution's kernel flip and the
    [up, skip] channel order."""
    make_jax, make_port = DECODERS[name]
    x = np.random.default_rng(3).normal(size=(16, 24, 64)).astype(np.float32)
    jm = make_jax()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(x))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = make_port()
    state = tnets.nets_from_flax(jax.tree.map(np.asarray, variables))
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    got = tm(to_torch(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)


def test_denoise_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.random((12, 20, 3)).astype(np.float32)
    kernels = rng.normal(size=(12, 20, 81)).astype(np.float32)
    want = np.asarray(jnets.denoise(jnp.asarray(img), jnp.asarray(kernels)))
    got = tnets.denoise(to_torch(img), to_torch(kernels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    centre = np.zeros_like(kernels)
    centre[..., 40] = 1.0
    assert torch.equal(tnets.denoise(to_torch(img), to_torch(centre)),
                       to_torch(img))


@pytest.mark.parametrize("h,w", [(12, 20), (5, 9)], ids=["12x20", "5x9"])
def test_denoise_gradients_match_jax(h, w):
    """Both gradients of the plain version (autograd through its taps and
    its reflect padding) against ``jax.vjp`` of the JAX ``denoise``: at
    test_denoise_matches_jax's size, and at H = 5, the smallest height a
    9x9 window's reflect padding allows, where rows reflect from both
    edges."""
    rng = np.random.default_rng(6)
    img = rng.random((h, w, 3)).astype(np.float32)
    kernels = rng.normal(size=(h, w, 81)).astype(np.float32)
    cot = rng.normal(size=(h, w, 3)).astype(np.float32)
    _, vjp = jax.vjp(jnets.denoise, jnp.asarray(img), jnp.asarray(kernels))
    want = jax.jit(vjp)(jnp.asarray(cot))
    ti = to_torch(img).requires_grad_()
    tk = to_torch(kernels).requires_grad_()
    got = torch.autograd.grad(tnets.denoise(ti, tk), (ti, tk),
                              to_torch(cot))
    for name, g, want_g in zip(("image", "map"), got, want):
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-4,
                                   atol=1e-5 * np.abs(want_g).max(),
                                   err_msg=name)


def test_denoise_takes_the_kernels_by_input_alone():
    """The route is decided from the device: a CUDA input takes the
    kernels, which accept float32 on one CUDA device at k = 9 and raise
    ``ValueError`` for anything else (judged here on stand-ins, as the CPU
    has no card); CPU tensors run the plain version and launch nothing. The
    map goes to the kernels as planes, as the CNN writes them: that view as
    it is, any other layout copied."""
    def like(device, dtype=torch.float32):
        return SimpleNamespace(device=torch.device(device), dtype=dtype)

    cuda = like("cuda:0")
    tdn.check_inputs(cuda, cuda, 9)
    refused = [(cuda, cuda, k) for k in (3, 7, 8, 11)] + [
        (cuda, like("cuda:1"), 9), (like("cpu"), cuda, 9),
        (cuda, like("cpu"), 9), (like("cpu"), like("cpu"), 9),
        (like("cuda:0", torch.float64), cuda, 9),
        (cuda, like("cuda:0", torch.bfloat16), 9)]
    for img, ker, k in refused:
        with pytest.raises(ValueError):
            tdn.check_inputs(img, ker, k)

    rng = np.random.default_rng(7)
    img = to_torch(rng.random((12, 20, 3)).astype(np.float32))
    conv_out = to_torch(rng.normal(size=(1, 81, 12, 20)).astype(np.float32))
    kernels = tnets._hwc(conv_out)
    assert tdn.planes(kernels) is kernels
    hwc = kernels.contiguous()
    as_planes = tdn.planes(hwc)
    assert as_planes.stride() == kernels.stride()
    assert torch.equal(as_planes, hwc)

    tdn.launches = tdn.bwd_launches = 0
    ti = img.clone().requires_grad_()
    out = tnets.denoise(ti, kernels)
    out.sum().backward()
    assert (tdn.launches, tdn.bwd_launches) == (0, 0)
    assert torch.equal(out, tnets.denoise_reference(img, kernels, 9))
    with pytest.raises(ValueError, match="reflect padding"):
        tnets.denoise(img[:4], kernels[:4])


def test_init_decoders_widths_and_statistics():
    """The port's decoders have the Flax decoders' parameter shapes (by the
    converter's names), zero biases, Kaiming-normal fan_in weights, and one
    seed gives the same weights."""
    jshapes = jax.eval_shape(jgr.init_decoders, jax.random.PRNGKey(0))
    dec = tgr.init_decoders(5, device="cpu")
    again = tgr.init_decoders(torch.Generator().manual_seed(5), device="cpu")
    for name, module in dec.items():
        want = tnets.nets_from_flax(jax.tree.map(
            lambda a: np.zeros(a.shape, np.float32), jshapes[name]))
        got = module.state_dict()
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}, name
        for key, value in got.items():
            assert torch.equal(value, again[name].state_dict()[key])
            if key.endswith("bias"):
                assert not value.any()
    w = dec["unet"].DoubleConv_2.Conv_1.weight          # 256 -> 256, 3x3
    assert abs(w.std().item() / np.sqrt(2 / (256 * 9)) - 1) < 0.01
    w = dec["unet"].ConvTranspose_0.weight              # 256 -> 128, 2x2
    assert abs(w.std().item() / np.sqrt(2 / (256 * 4)) - 1) < 0.01
