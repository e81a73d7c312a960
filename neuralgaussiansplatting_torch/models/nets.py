"""Screen-space neural decoders of the neural-feature path.

Port of ``models/nets.py`` (the Flax modules of the reference's
``utils/net_utils.py``): ``FeatureToRGBMLP``, ``DoubleConv``, ``UNet``,
``SmallUNet``, ``CNN`` (the 81-channel dynamic-kernel predictor),
``PureCNN``, and the parameter-free dynamic 9x9 filter ``denoise`` (one
CUDA kernel each way on the card, ``ops/denoise``).

Each module takes one (H, W, C) image and returns (H, W, out) float32, the
JAX call contract; inside, the convolutions run on (1, C, H, W) tensors (a
permuted view, which PyTorch treats as channels-last). ``dtype`` means what
it means in Flax: the parameters stay float32, the layers compute in
``dtype`` (e.g. ``torch.bfloat16``), and the output is cast back to float32.
``SmallUNet`` and ``PureCNN`` have no ``dtype`` there and none here.

Submodules carry the Flax modules' automatic names (``Dense_0``,
``Conv_1``, ``DoubleConv_2``, ``ConvTranspose_0``, ...), so the path of a
Flax variable is the key of its tensor in the ``state_dict``;
``nets_from_flax`` converts the layouts. ``kaiming_init_`` draws the Flax
initialisation (Kaiming-normal, fan_in, gain sqrt(2); zero biases) from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neuralgaussiansplatting_torch.ops import denoise as denoise_ops

NUM_FEATURES = 64


def _linear(layer: nn.Linear, x, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def _conv(layer: nn.Conv2d, x, dtype):
    return F.conv2d(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype), padding=layer.padding)


def _conv_transpose(layer: nn.ConvTranspose2d, x, dtype):
    return F.conv_transpose2d(x.to(dtype), layer.weight.to(dtype),
                              layer.bias.to(dtype), stride=layer.stride)


def _nchw(x):
    """(H, W, C) -> (1, C, H, W), a view."""
    return x.permute(2, 0, 1)[None]


def _hwc(x):
    """(1, C, H, W) -> (H, W, C) float32."""
    return x[0].permute(1, 2, 0).float()


class FeatureToRGBMLP(nn.Module):
    """Per-pixel MLP: in -> 128 -> 128 -> 3 with ReLUs."""

    def __init__(self, hidden_features: int = 128, out_features: int = 3,
                 in_features: int = NUM_FEATURES):
        super().__init__()
        self.out_features = out_features
        self.Dense_0 = nn.Linear(in_features, hidden_features)
        self.Dense_1 = nn.Linear(hidden_features, hidden_features)
        self.Dense_2 = nn.Linear(hidden_features, out_features)

    def forward(self, x, dtype=torch.float32):   # (H, W, C)
        h, w, c = x.shape
        y = x.reshape(-1, c)
        y = F.relu(_linear(self.Dense_0, y, dtype))
        y = F.relu(_linear(self.Dense_1, y, dtype))
        y = _linear(self.Dense_2, y, dtype)
        return y.reshape(h, w, self.out_features).float()


class DoubleConv(nn.Module):
    """Two 3x3 convolutions with ReLUs, on (1, C, H, W)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, 3, padding=1)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x, dtype=torch.float32):
        x = F.relu(_conv(self.Conv_0, x, dtype))
        return F.relu(_conv(self.Conv_1, x, dtype))


class UNet(nn.Module):
    """3-level encoder/decoder with 2x2 stride-2 transposed-convolution
    upsampling and skips; H and W must be multiples of 4."""

    def __init__(self, out_channels: int = 3, base_channels: int = 64,
                 in_channels: int = NUM_FEATURES):
        super().__init__()
        b = base_channels
        self.DoubleConv_0 = DoubleConv(in_channels, b)
        self.DoubleConv_1 = DoubleConv(b, 2 * b)
        self.DoubleConv_2 = DoubleConv(2 * b, 4 * b)
        self.ConvTranspose_0 = nn.ConvTranspose2d(4 * b, 2 * b, 2, stride=2)
        self.DoubleConv_3 = DoubleConv(4 * b, 2 * b)
        self.ConvTranspose_1 = nn.ConvTranspose2d(2 * b, b, 2, stride=2)
        self.DoubleConv_4 = DoubleConv(2 * b, b)
        self.Conv_0 = nn.Conv2d(b, out_channels, 1)

    def forward(self, x, dtype=torch.float32):   # (H, W, C) -> (H, W, out)
        x = _nchw(x)
        e1 = self.DoubleConv_0(x, dtype)
        e2 = self.DoubleConv_1(F.max_pool2d(e1, 2), dtype)
        e3 = self.DoubleConv_2(F.max_pool2d(e2, 2), dtype)
        up2 = _conv_transpose(self.ConvTranspose_0, e3, dtype)
        d2 = self.DoubleConv_3(torch.cat([up2, e2], dim=1), dtype)
        up1 = _conv_transpose(self.ConvTranspose_1, d2, dtype)
        d1 = self.DoubleConv_4(torch.cat([up1, e1], dim=1), dtype)
        return _hwc(_conv(self.Conv_0, d1, dtype))


class SmallUNet(nn.Module):
    """2-level variant (unused by the render paths; part of the public
    surface); H and W must be even."""

    def __init__(self, out_channels: int = 3, base_channels: int = 64,
                 in_channels: int = NUM_FEATURES):
        super().__init__()
        b = base_channels
        self.DoubleConv_0 = DoubleConv(in_channels, b)
        self.DoubleConv_1 = DoubleConv(b, 2 * b)
        self.ConvTranspose_0 = nn.ConvTranspose2d(2 * b, b, 2, stride=2)
        self.DoubleConv_2 = DoubleConv(2 * b, b)
        self.Conv_0 = nn.Conv2d(b, out_channels, 1)

    def forward(self, x):
        f32 = torch.float32
        x = _nchw(x)
        e1 = self.DoubleConv_0(x, f32)
        e2 = self.DoubleConv_1(F.max_pool2d(e1, 2), f32)
        up1 = _conv_transpose(self.ConvTranspose_0, e2, f32)
        d1 = self.DoubleConv_2(torch.cat([up1, e1], dim=1), f32)
        return _hwc(_conv(self.Conv_0, d1, f32))


class CNN(nn.Module):
    """5x5 convolutional kernel predictor: in -> 100 -> 81 channels (one
    9x9 kernel per pixel)."""

    def __init__(self, mid_channels: int = 100, out_channels: int = 81,
                 kernel_size: int = 5, in_channels: int = NUM_FEATURES):
        super().__init__()
        pad = kernel_size // 2
        self.Conv_0 = nn.Conv2d(in_channels, mid_channels, kernel_size,
                                padding=pad)
        self.Conv_1 = nn.Conv2d(mid_channels, out_channels, kernel_size,
                                padding=pad)

    def forward(self, x, dtype=torch.float32):   # (H, W, C) -> (H, W, 81)
        x = F.relu(_conv(self.Conv_0, _nchw(x), dtype))
        return _hwc(_conv(self.Conv_1, x, dtype))


class PureCNN(nn.Module):
    """Direct-to-RGB variant of ``CNN``."""

    def __init__(self, mid_channels: int = 100, out_channels: int = 3,
                 kernel_size: int = 5, in_channels: int = NUM_FEATURES):
        super().__init__()
        pad = kernel_size // 2
        self.Conv_0 = nn.Conv2d(in_channels, mid_channels, kernel_size,
                                padding=pad)
        self.Conv_1 = nn.Conv2d(mid_channels, out_channels, kernel_size,
                                padding=pad)

    def forward(self, x):
        f32 = torch.float32
        x = F.relu(_conv(self.Conv_0, _nchw(x), f32))
        return _hwc(_conv(self.Conv_1, x, f32))


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """(H, W, C) -> (H + 2 pad, W + 2 pad, C), reflected without repeating
    the edge (``F.pad``'s "reflect"), built from flipped slices: its
    backward sums each pixel's cotangents in autograd's fixed order, where
    ``F.pad``'s backward adds them with atomics on CUDA, in an order that
    changes from run to run."""
    h, w = x.shape[:2]
    x = torch.cat([x[1:pad + 1].flip(0), x, x[h - 1 - pad:h - 1].flip(0)])
    return torch.cat([x[:, 1:pad + 1].flip(1), x,
                      x[:, w - 1 - pad:w - 1].flip(1)], dim=1)


def denoise(unet_out: torch.Tensor, cnn_out: torch.Tensor,
            kernel_size: int = 9) -> torch.Tensor:
    """Dynamic per-pixel filtering (the reference's Denoiser).

    ``unet_out`` (H, W, 3) is reflect-padded by k // 2 (< H, W) and each
    pixel's k x k window is weighted by its kernel in ``cnn_out``
    (H, W, k*k), tap i = ky*k + kx (torch-unfold order); the taps are added
    one by one in that order, as the JAX package adds them.

    On a CUDA device it runs one kernel each way (``ops/denoise``), whose
    forward gives the plain version's bits; there the image and map must be
    float32 on one device and k = 9, else ``ValueError``. CPU tensors run
    the plain version, ``denoise_reference``.
    """
    h, w, c = unet_out.shape
    if c != 3:
        raise ValueError(f"denoise takes an (H, W, 3) image, got "
                         f"{tuple(unet_out.shape)}")
    k = kernel_size
    if k // 2 >= min(h, w):
        raise ValueError(f"a {k}x{k} denoiser's reflect padding needs H and "
                         f"W above {k // 2}, got {h}x{w}")
    kernels = cnn_out.reshape(h, w, k * k)
    if unet_out.is_cuda or kernels.is_cuda:
        return denoise_ops.denoise(unet_out, kernels, k)
    return denoise_reference(unet_out, kernels, k)


def denoise_reference(unet_out: torch.Tensor, kernels: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Plain PyTorch version of ``denoise``, on any device: ``kernels``
    (H, W, k*k), k // 2 < H, W; the taps added one by one, differentiated
    by autograd."""
    h, w = unet_out.shape[:2]
    img = _reflect_pad(unet_out, k // 2)
    out = torch.zeros_like(unet_out)
    for i in range(k * k):
        dy, dx = divmod(i, k)
        out = out + img[dy:dy + h, dx:dx + w, :] * kernels[:, :, i:i + 1]
    return out


@torch.no_grad()
def kaiming_init_(module: nn.Module, generator: torch.Generator):
    """Draw every weight of ``module`` as the Flax modules initialise them:
    normal with std sqrt(2 / fan_in), fan_in = input channels x kernel
    area (for a transposed convolution too, as Flax counts it); biases
    zero. Draws on the CPU from ``generator`` (a CPU generator), in
    registration order, so one seed gives the same weights on every
    device."""
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            fan_in = layer.in_features
        elif isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = layer.kernel_size
            fan_in = layer.in_channels * kh * kw
        else:
            continue
        w = torch.randn(layer.weight.shape, generator=generator)
        layer.weight.copy_(w * math.sqrt(2.0 / fan_in))
        layer.bias.zero_()
    return module


def nets_from_flax(variables) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of a module of this file from the variables of its
    Flax counterpart (``{"params": {...}}`` or the params tree, leaves as
    numpy arrays). Dense kernels (in, out) become (out, in); Conv kernels
    HWIO become OIHW; ConvTranspose kernels (kh, kw, in, out) become
    (in, out, kh, kw), flipped in both spatial axes: Flax's transposed
    convolution (``transpose_kernel=False``, SAME padding) dilates the input
    and correlates with the kernel as it is, PyTorch's is the adjoint of a
    correlation, so at stride 2 output pixel 2m takes kernel tap 1 in Flax
    and tap 0 in PyTorch."""
    tree = variables["params"] if "params" in variables else variables
    out = {}

    def walk(node, path):
        for key, value in node.items():
            if hasattr(value, "items"):
                walk(value, path + (key,))
                continue
            a = np.array(value, dtype=np.float32)     # a writable copy
            if key == "kernel":
                if a.ndim == 2:
                    a = a.T
                elif path[-1].startswith("ConvTranspose"):
                    a = a[::-1, ::-1].transpose(2, 3, 0, 1)
                else:
                    a = a.transpose(3, 2, 0, 1)
                key = "weight"
            elif key != "bias":
                raise KeyError(f"unexpected Flax leaf {'/'.join(path)}/{key}")
            out[".".join(path + (key,))] = torch.from_numpy(
                np.ascontiguousarray(a))

    walk(tree, ())
    return out
