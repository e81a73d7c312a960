"""The neural path's dynamic per-pixel filter on the card: one kernel each
way.

``models/nets.denoise`` runs ``denoise`` here for every input on a CUDA
device: a float32 image (H, W, 3) with a float32 kernel map (H, W, 81) on
the same device, the published 9x9 window, the one the CUDA sources are
built for (``KERNEL_SIZE``). Any other input on the card raises
``ValueError``; it never falls back to the plain version, the 81-tap loop,
which runs only for CPU tensors. The forward (``csrc/denoise_fwd.cu``)
gives that loop's bits; the backward (``csrc/denoise_bwd.cu``) gives both
gradients in one launch, in a fixed order of adds and without atomics,
within rounding of autograd's through the loop. ``launches`` and
``bwd_launches`` count them.

Layouts. The kernels read the map as contiguous (81, H, W) planes, which
is how the CNN writes it: ``nets._hwc`` hands over a permuted view of
(1, 81, H, W), taken as it is; a map in any other layout is copied into
planes. The map's gradient comes back as planes, in the same permuted view,
so the CNN's last convolution gets a contiguous NCHW gradient. The image,
the output, the cotangent and the image's gradient go by their strides; the
output and the image's gradient take the image's layout.
"""

from __future__ import annotations

import ctypes

import torch

from neuralgaussiansplatting_torch.ops import _build

launches = 0      # forward kernel launches since the caller last set it to 0
bwd_launches = 0  # backward kernel launches since the caller last set it to 0

KERNEL_SIZE = 9  # the window the kernels are built for (csrc's kK)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C signatures of csrc/denoise_{fwd,bwd}.cu (the last pointer is the
# stream)
_FWD_ARGS = (_P, _LL, _LL, _LL, _P, _P, _LL, _LL, _LL, _I, _I, _P)
_BWD_ARGS = (_P, _LL, _LL, _LL, _P, _P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P,
             _I, _I, _P)


def check_inputs(img: torch.Tensor, kernels: torch.Tensor, k: int) -> None:
    """Raise ``ValueError`` unless the kernels take this (H, W, 3) image and
    (H, W, k*k) map: both float32 on one CUDA device, k = KERNEL_SIZE."""
    if k != KERNEL_SIZE:
        raise ValueError(f"the denoiser's CUDA kernels are built for a "
                         f"{KERNEL_SIZE}x{KERNEL_SIZE} window, got {k}x{k}")
    if img.device.type != "cuda" or kernels.device != img.device:
        raise ValueError(f"the denoiser's image and map must be on one CUDA "
                         f"device, got {img.device} and {kernels.device}")
    if img.dtype != torch.float32 or kernels.dtype != torch.float32:
        raise ValueError(f"the denoiser's CUDA kernels take float32, got "
                         f"{img.dtype} and {kernels.dtype}")


def planes(kernels: torch.Tensor) -> torch.Tensor:
    """The (H, W, 81) map as a view of contiguous (81, H, W) planes: the
    map itself where it is one, else a copy."""
    h, w, _ = kernels.shape
    if kernels.stride() == (w, 1, h * w):
        return kernels
    return kernels.permute(2, 0, 1).contiguous().permute(1, 2, 0)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


class _Denoise(torch.autograd.Function):
    """The forward kernel and the backward kernel, differentiable in the
    image and the map. Saves only its inputs."""

    @staticmethod
    def forward(ctx, img, kernels):
        global launches
        h, w = img.shape[:2]
        out = torch.empty_like(img)
        _build.launch("denoise_fwd", _FWD_ARGS, img.device, img.data_ptr(),
                      *img.stride(), kernels.data_ptr(), out.data_ptr(),
                      *out.stride(), h, w)
        launches += 1
        ctx.save_for_backward(img, kernels)
        return out

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        img, kernels = ctx.saved_tensors
        h, w = img.shape[:2]
        g_img = torch.empty_like(img) if ctx.needs_input_grad[0] else None
        g_ker = (kernels.new_empty((KERNEL_SIZE ** 2, h, w))
                 if ctx.needs_input_grad[1] else None)
        _build.launch("denoise_bwd", _BWD_ARGS, img.device, img.data_ptr(),
                      *img.stride(), kernels.data_ptr(), g.data_ptr(),
                      *g.stride(), _ptr(g_img),
                      *(g_img.stride() if g_img is not None else (0, 0, 0)),
                      _ptr(g_ker), h, w)
        bwd_launches += 1
        return g_img, None if g_ker is None else g_ker.permute(1, 2, 0)


def denoise(img: torch.Tensor, kernels: torch.Tensor, k: int) -> torch.Tensor:
    """``nets.denoise`` by the kernels: ``img`` (H, W, 3), ``kernels``
    (H, W, k*k), k // 2 < H, W; ``ValueError`` for inputs that
    ``check_inputs`` refuses."""
    check_inputs(img, kernels, k)
    return _Denoise.apply(img, planes(kernels))
