"""LPIPS perceptual metric (port of ``utils/lpips.py``).

VGG16's ``features`` stack (3x3 convolutions with padding 1, ReLU, 2x2 max
pools) on the image scaled to [-1, 1] and shifted by LPIPS's ImageNet
constants; each of the five stages' activations unit-normalised over the
channel axis (eps 1e-10 added to the norm), the squared differences of the
two images weighted per channel by the learned "lin" vectors, averaged over
the pixels and summed over the stages.

Weights: the same ``.npz`` as the JAX package reads (``$NGS_LPIPS_WEIGHTS``,
else ``weights/lpips_vgg.npz``; ``export_weights_from_torch`` writes it).
Its convolution weights are HWIO; ``torch_params`` permutes them to OIHW
once, which is this module's weight carry-over. ``lpips_fn`` returns None
when no weights are found, so callers report LPIPS as unavailable rather
than wrong.

The convolutions are cuDNN's, run under ``losses._exact_cudnn`` (no TF32,
deterministic algorithms), so the card computes the float32 function the
JAX package defines.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from neuralgaussiansplatting_torch import resolve_device
from neuralgaussiansplatting_torch.utils.losses import _exact_cudnn

# VGG16 conv plan: (out_channels, n_convs) per stage; stages end before pool.
VGG16_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# ImageNet scaling used by LPIPS (modules/utils.py)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _normalize_activation(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """(N, C, H, W) activations over unit-length channel vectors."""
    norm = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True))
    return x / (norm + eps)


def vgg16_features(params: dict, img_chw: torch.Tensor) -> list:
    """img (3, H, W) in [0, 1] -> the 5 stage activations, each
    (1, C, H', W'). ``params`` are ``torch_params``' tensors."""
    shift = torch.from_numpy(_SHIFT).to(img_chw.device).view(3, 1, 1)
    scale = torch.from_numpy(_SCALE).to(img_chw.device).view(3, 1, 1)
    x = ((img_chw * 2.0 - 1.0 - shift) / scale)[None]
    feats = []
    li = 0
    with _exact_cudnn():
        for _, n_convs in VGG16_STAGES:
            for _ in range(n_convs):
                x = F.relu(F.conv2d(x, params[f"conv{li}_w"],
                                    params[f"conv{li}_b"], padding=1))
                li += 1
            feats.append(x)
            x = F.max_pool2d(x, 2, 2)
    return feats


def lpips_pair(params: dict, a_chw: torch.Tensor,
               b_chw: torch.Tensor) -> torch.Tensor:
    """LPIPS distance of two (3, H, W) images in [0, 1], a 0-d tensor."""
    total = a_chw.new_zeros(())
    for i, (xa, xb) in enumerate(zip(vgg16_features(params, a_chw),
                                     vgg16_features(params, b_chw))):
        d = (_normalize_activation(xa) - _normalize_activation(xb)) ** 2
        w = params[f"lin{i}_w"].view(1, -1, 1, 1)
        total = total + torch.mean(torch.sum(d * w, dim=1))
    return total


def default_weights_path(net_type: str = "vgg") -> str:
    """Conventional in-repo location for the exported weights artifact."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "weights", f"lpips_{net_type}.npz")


@functools.lru_cache(maxsize=1)
def _load_params(net_type: str):
    """The ``.npz``'s arrays as numpy (HWIO convolutions), or None."""
    path = os.environ.get("NGS_LPIPS_WEIGHTS", "")
    if not path:
        path = default_weights_path(net_type)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def torch_params(params: dict, device) -> dict:
    """``_load_params``' arrays as float32 tensors on ``device``, the
    convolution weights permuted HWIO -> OIHW."""
    out = {}
    for k, v in params.items():
        t = torch.from_numpy(np.asarray(v, np.float32))
        if k.endswith("_w") and t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        out[k] = t.to(device)
    return out


def lpips_fn(net_type: str = "vgg", device="cuda"):
    """A callable (a, b) -> float on (3, H, W) images (numpy arrays or
    tensors) computed on ``device``, or None if no weights are found."""
    params = _load_params(net_type)
    if params is None:
        return None
    dev = resolve_device(device)
    tparams = torch_params(params, dev)

    def call(a, b):
        with torch.no_grad():
            return float(lpips_pair(tparams, torch.as_tensor(a, device=dev),
                                    torch.as_tensor(b, device=dev)))
    return call


def export_weights_from_torch(out_path: str, net_type: str = "vgg"):
    """Convert torchvision VGG16 + lpips lin weights into the .npz this
    module loads. Run on a machine with torchvision + lpips checkpoints."""
    import torchvision

    vgg = torchvision.models.vgg16(weights="IMAGENET1K_V1").features
    out = {}
    li = 0
    for layer in vgg:
        if isinstance(layer, torch.nn.Conv2d):
            out[f"conv{li}_w"] = (
                layer.weight.detach().numpy().transpose(2, 3, 1, 0))
            out[f"conv{li}_b"] = layer.bias.detach().numpy()
            li += 1
    # lin layers: load from the lpips package checkpoint if available
    try:
        import lpips as lpips_pkg
        model = lpips_pkg.LPIPS(net="vgg")
        for i, lin in enumerate(model.lins):
            w = lin.model[-1].weight.detach().numpy().reshape(-1)
            out[f"lin{i}_w"] = np.maximum(w, 0.0)
    except ImportError:
        for i, (c, _) in enumerate(VGG16_STAGES):
            out[f"lin{i}_w"] = np.full(c, 1.0 / c, np.float32)
    np.savez(out_path, **out)
