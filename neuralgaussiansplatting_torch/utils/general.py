"""General utilities (port of ``utils/general.py``): the sigmoid inverse, the
exponential learning-rate schedule and the rotation builders.

``pil_to_array`` is not ported: it belongs to the scene layer's image
loading, which is a later slice of the port.
"""

from __future__ import annotations

import torch

from neuralgaussiansplatting_torch.ops import transforms
from neuralgaussiansplatting_torch.train.optim import expon_lr_schedule


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return transforms.inverse_sigmoid(x)


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1_000_000):
    return expon_lr_schedule(lr_init, lr_final, lr_delay_steps,
                             lr_delay_mult, max_steps)


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    return transforms.quat_to_rotmat(q)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return transforms.build_scaling_rotation(s, q)
