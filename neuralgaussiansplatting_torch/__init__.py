"""PyTorch + CUDA port of NeuralGaussianSplatting for NVIDIA Hopper (H100).

Mirrors the layout and public names of ``neuralgaussiansplatting_tpu`` (the
JAX reference, which stays the contract this package is tested against) but
never imports it or JAX. Entry points that create tensors default to
``device="cuda"`` and raise when no GPU is present; functions that take
tensors run on the tensors' device. On a CUDA tensor every kernel wrapper
launches its hand-written kernel (``csrc/``) or raises; only a CPU tensor
takes the kernel's plain PyTorch version.
"""

import os

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and absent.

    Never substitutes the CPU for a missing GPU: a caller who wants the CPU
    passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def platform_device() -> torch.device:
    """The entry points' device: the CUDA device, or the CPU when the
    environment sets ``NGS_PLATFORM=cpu``; raises without a GPU otherwise
    (there is no fallback from one to the other)."""
    return resolve_device(
        "cpu" if os.environ.get("NGS_PLATFORM") == "cpu" else "cuda")
