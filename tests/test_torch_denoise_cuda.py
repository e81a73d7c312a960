"""The denoiser's kernels (``csrc/denoise_{fwd,bwd}.cu``) on the card,
against the plain version (``nets.denoise_reference``) and autograd through
it.

This file imports no JAX, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_denoise_cuda.py

The forward adds the taps in the plain version's order and rounds each
product and add on its own, so it is held bit for bit. The backward sums
in an order of its own (a gather per padded position, then the reflect
fold), so both gradients are held within 1e-5 of the plain version's
largest |gradient|, and to their own bits over repeated calls.

Sizes: the benchmark's 800x800, an odd size that no tile divides (37x53),
and 5x7, the smallest height the 9x9 reflect padding allows, where a row
has up to three padded positions.
"""

import pytest
import torch

from neuralgaussiansplatting_torch.models import nets
from neuralgaussiansplatting_torch.ops import denoise as dn

SIZES = [(800, 800), (37, 53), (5, 7)]
IDS = [f"{h}x{w}" for h, w in SIZES]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on an NVIDIA GPU")


def _inputs(h, w, seed=0, layout="cnn"):
    """(image, map, cotangent) on the card. ``layout`` "cnn": the image
    and the map as the decoders hand them over, permuted views of
    (1, C, H, W); "hwc": contiguous (H, W, C) tensors."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((1, 3, h, w), generator=gen, device="cuda")
    ker = torch.randn((1, 81, h, w), generator=gen, device="cuda") * 0.2
    cot = torch.randn((h, w, 3), generator=gen, device="cuda")
    img, ker = img[0].permute(1, 2, 0), ker[0].permute(1, 2, 0)
    if layout == "hwc":
        img, ker = img.contiguous(), ker.contiguous()
    return img, ker, cot


def _grads(fn, img, ker, cot):
    img = img.detach().requires_grad_()
    ker = ker.detach().requires_grad_()
    out = fn(img, ker, 9)
    g_img, g_ker = torch.autograd.grad(out, (img, ker), cot)
    return out.detach(), g_img, g_ker


def _assert_close(got, want, name):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * scale, f"{name}: {err} against scale {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", SIZES, ids=IDS)
@pytest.mark.parametrize("layout", ["cnn", "hwc"])
def test_forward_is_the_plain_version_bit_for_bit(h, w, layout):
    _need_gpu()
    img, ker, _ = _inputs(h, w, layout=layout)
    dn.launches = 0
    got = nets.denoise(img, ker)
    assert dn.launches == 1
    want = nets.denoise_reference(img, ker, 9)
    assert got.stride() == img.stride()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", SIZES, ids=IDS)
def test_gradients_match_autograd_through_the_plain_version(h, w):
    _need_gpu()
    img, ker, cot = _inputs(h, w, seed=1)
    dn.launches = dn.bwd_launches = 0
    out, g_img, g_ker = _grads(nets.denoise, img, ker, cot)
    assert (dn.launches, dn.bwd_launches) == (1, 1)
    want_out, want_img, want_ker = _grads(nets.denoise_reference, img, ker,
                                          cot)
    assert torch.equal(out, want_out)
    _assert_close(g_img, want_img, "image gradient")
    _assert_close(g_ker, want_ker, "map gradient")


@pytest.mark.cuda
def test_gradients_of_an_hwc_image_and_map_and_of_each_input_alone():
    """Contiguous (H, W, C) inputs (render3's MLP image; a map copied into
    planes); then one input requiring grad at a time."""
    _need_gpu()
    img, ker, cot = _inputs(37, 53, seed=2, layout="hwc")
    _, g_img, g_ker = _grads(nets.denoise, img, ker, cot)
    _, want_img, want_ker = _grads(nets.denoise_reference, img, ker, cot)
    assert g_img.stride() == img.stride()
    _assert_close(g_img, want_img, "image gradient")
    _assert_close(g_ker, want_ker, "map gradient")
    only_img = img.detach().requires_grad_()
    got = torch.autograd.grad(nets.denoise(only_img, ker), only_img, cot)[0]
    assert torch.equal(got, g_img)
    only_ker = ker.detach().requires_grad_()
    got = torch.autograd.grad(nets.denoise(img, only_ker), only_ker, cot)[0]
    assert torch.equal(got, g_ker)


@pytest.mark.cuda
def test_backward_repeats_and_returns_the_map_gradient_as_planes():
    """20 backward passes at 800x800 give the same bits; the map's
    gradient is a permuted view of contiguous (1, 81, H, W) planes, the
    layout the CNN's last convolution takes; one launch each way a call."""
    _need_gpu()
    img, ker, cot = _inputs(800, 800, seed=3)
    _, first_img, first_ker = _grads(nets.denoise, img, ker, cot)
    assert first_ker.stride() == (800, 1, 800 * 800)
    assert first_ker.permute(2, 0, 1).is_contiguous()
    for _ in range(20):
        dn.launches = dn.bwd_launches = 0
        _, g_img, g_ker = _grads(nets.denoise, img, ker, cot)
        assert (dn.launches, dn.bwd_launches) == (1, 1)
        assert torch.equal(g_img, first_img)
        assert torch.equal(g_ker, first_ker)


@pytest.mark.cuda
def test_map_gradient_reaches_the_cnn_as_contiguous_nchw():
    """Through ``_hwc``'s permute, the CNN's output gets its gradient as a
    contiguous (1, 81, H, W) tensor."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(4)
    conv_out = torch.randn((1, 81, 64, 96), generator=gen, device="cuda",
                           requires_grad=True)
    img = torch.rand((64, 96, 3), generator=gen, device="cuda")
    out = nets.denoise(img, nets._hwc(conv_out))
    g = torch.autograd.grad(out, conv_out, torch.ones_like(out))[0]
    assert g.is_contiguous()


@pytest.mark.cuda
def test_cpu_inputs_take_the_plain_version_and_other_card_inputs_raise():
    """A CPU input runs the plain version; on the card, float64, a k the
    kernels are not built for (7) and an image and map on two devices raise
    ``ValueError``: a CUDA input never falls back to the plain version.
    Nothing launches."""
    _need_gpu()
    img, ker, _ = _inputs(37, 53, seed=5)
    dn.launches = 0
    got = nets.denoise(img.cpu(), ker.cpu())
    assert torch.equal(got, nets.denoise_reference(img.cpu(), ker.cpu(), 9))
    gen = torch.Generator(device="cuda").manual_seed(6)
    map_7 = torch.randn((37, 53, 49), generator=gen, device="cuda")
    for a, b, k in [(img.double(), ker.double(), 9), (img, map_7, 7),
                    (img.cpu(), ker, 9), (img, ker.cpu(), 9)]:
        with pytest.raises(ValueError):
            nets.denoise(a, b, k)
    assert dn.launches == 0
