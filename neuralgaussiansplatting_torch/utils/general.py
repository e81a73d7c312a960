"""General utilities (port of ``utils/general.py``): the run's stdout and
seeds, the sigmoid inverse, the exponential learning-rate schedule, the
rotation builders and the image-to-array conversion of the scene layer.
"""

from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np
import torch

from neuralgaussiansplatting_torch.ops import transforms
from neuralgaussiansplatting_torch.train.optim import expon_lr_schedule


class _TimestampedStdout:
    def __init__(self, inner, silent: bool):
        self.inner = inner
        self.silent = silent

    def write(self, x):
        if self.silent:
            return
        if x.endswith("\n"):
            ts = datetime.now().strftime("%d/%m %H:%M:%S")
            x = x.replace("\n", f" [{ts}]\n")
        self.inner.write(x)

    def flush(self):
        self.inner.flush()

    def __getattr__(self, name):
        return getattr(self.inner, name)


def safe_state(silent: bool = False, seed: int = 0):
    """Timestamp stdout lines (drop them all when ``silent``) and seed
    ``random``, numpy and torch, as the reference does. Returns the stdout
    it replaced, for a caller that restores it."""
    previous = sys.stdout
    sys.stdout = _TimestampedStdout(previous, silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return previous


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return transforms.inverse_sigmoid(x)


def pil_to_array(image: np.ndarray, resolution) -> np.ndarray:
    """The JAX package's ``pil_to_array`` for a uint8 (H, W, C) image:
    resized to ``resolution`` (W, H) as Pillow does, as (C, H, W) float32
    in [0, 1]."""
    from neuralgaussiansplatting_torch.scene.loader import pil_to_array as f
    return f(image, resolution)


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1_000_000):
    return expon_lr_schedule(lr_init, lr_final, lr_delay_steps,
                             lr_delay_mult, max_steps)


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    return transforms.quat_to_rotmat(q)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return transforms.build_scaling_rotation(s, q)
