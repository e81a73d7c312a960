"""Per-group Adam over the Gaussian parameters, as plain tensor code.

Port of ``train/optim.py`` (an ``optax.multi_transform`` of per-group Adam
there): the reference's learning rates per group, Adam eps 1e-15, the xyz
group on the exponential schedule scaled by ``spatial_lr_scale``, ``f_rest``
at feature_lr / 20 and ``normals`` frozen. The state is one ``AdamGroup``
(mu, nu, count) per optimized leaf of ``GaussianParams``, so densification
can zero a group's rows (``train/densify.py``).

One update follows ``optax.scale_by_adam`` then ``scale_by_learning_rate``:

    mu    = (1 - b1) g + b1 mu
    nu    = (1 - b2) g^2 + b2 nu
    count = count + 1
    p     = p + (-lr(count_before)) * (mu / (1 - b1^count))
                                     / (sqrt(nu / (1 - b2^count)) + eps)

The learning rate and the bias corrections are float32 values computed on
the host from the step count, which the state keeps as a Python int.

``Adam.update`` takes an optional per-row ``alive`` mask: the gradients of
dead (padding) rows are read as 0, as ``torch.where`` selects them. On CUDA
tensors every group of a call is updated by one kernel launch
(``csrc/adam_update.cu``; ``launches`` counts them), bit-equal to
``Adam.update_reference``, the plain version, which runs on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from neuralgaussiansplatting_torch.ops import _build

launches = 0  # fused Adam launches since the caller last set it to 0

# csrc/adam_update.cu: the groups one launch takes, and its C signature
# (ptrs, sizes, scalars, count, coefs; the last pointer is the stream)
MAX_GROUPS = 32
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p)


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    """The reference's optimization arguments, with its defaults."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False


def expon_lr_schedule(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1_000_000) -> Callable[[int], float]:
    """Log-lerp decay from ``lr_init`` to ``lr_final`` over ``max_steps``
    with an optional sine delay; the rate is computed in float32."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * math.pi) * np.clip(step / f32(lr_delay_steps),
                                             f32(0), f32(1)))
        else:
            delay_rate = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                          + np.log(f32(lr_final)) * t)
        return float(f32(delay_rate * log_lerp))

    return schedule


class AdamGroup(NamedTuple):
    """Adam state of one parameter group."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: int


def _leaves(tree) -> dict:
    """{name: tensor} of a NamedTuple (``GaussianParams``) or a mapping."""
    return tree._asdict() if hasattr(tree, "_asdict") else dict(tree)


@dataclasses.dataclass(frozen=True, eq=False)
class Adam:
    """Adam over the leaves named in ``lrs`` (each a constant rate or a
    schedule of the step count) of a ``GaussianParams`` or of a mapping of
    named tensors; other leaves stay as they are."""

    lrs: dict
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15

    def init(self, params) -> dict:
        leaves = _leaves(params)
        return {name: AdamGroup(torch.zeros_like(leaves[name]),
                                torch.zeros_like(leaves[name]), 0)
                for name in self.lrs}

    def update(self, grads, state: dict, params, alive=None):
        """One Adam step: returns (new params, of ``params``' type, and new
        state). A gradient may be None (read as zeros); ``alive`` (N,) bool,
        if given, zeroes the gradients of the rows it marks dead. On CUDA
        one kernel launch updates every group (``MAX_GROUPS`` a launch),
        bit-equal to ``update_reference``, which runs elsewhere."""
        leaves = _leaves(params)
        if any(leaves[name].device.type != "cuda" for name in self.lrs):
            return self.update_reference(grads, state, params, alive)
        global launches
        f32 = np.float32
        grads = _leaves(grads)
        dev = leaves[next(iter(self.lrs))].device
        if alive is not None:
            alive = alive.to(dev, torch.bool).reshape(-1).contiguous()
        # held until the launches are queued: a contiguous copy freed
        # earlier could be handed to a later group's outputs
        held, ptrs, sizes, scalars, new_state = [], [], [], [], {}
        for name, lr in self.lrs.items():
            p, mu, nu = (_kernel_input(t, leaves[name].shape, name)
                         for t in (leaves[name], *state[name][:2]))
            g = grads[name]
            g = None if g is None else _kernel_input(g, p.shape, name)
            mask = None if g is None else alive
            if mask is not None and mask.numel() != p.shape[0]:
                raise ValueError(f"alive has {mask.numel()} rows, {name} "
                                 f"{p.shape[0]}")
            count = state[name].count
            rate = lr(count) if callable(lr) else lr
            bc1 = f32(1) - f32(self.b1) ** f32(count + 1)
            bc2 = f32(1) - f32(self.b2) ** f32(count + 1)
            outs = [torch.empty_like(p) for _ in range(3)]
            leaves[name] = outs[0]
            new_state[name] = AdamGroup(outs[1], outs[2], count + 1)
            if not p.numel():
                continue
            held += [p, g, mu, nu]
            ptrs.append([_ptr(t) for t in (p, g, mu, nu, *outs, mask)])
            sizes.append((p.numel(), p[0].numel() if p.ndim else 1))
            # PyTorch's CUDA division by a host scalar multiplies by its
            # float32 reciprocal: the kernel takes 1 / bc, rounded alike
            scalars.append((f32(-rate), f32(1) / bc1, f32(1) / bc2,
                            f32(self.eps)))
        ptrs = np.array(ptrs, dtype=np.int64)
        sizes = np.array(sizes, dtype=np.int64)
        scalars = np.array(scalars, dtype=np.float32)
        coefs = np.array([1 - self.b1, self.b1, 1 - self.b2, self.b2],
                         dtype=np.float32)
        for i in range(0, len(ptrs), MAX_GROUPS):
            _build.launch("adam_update", _ARGS, dev,
                          ptrs[i:].ctypes.data, sizes[i:].ctypes.data,
                          scalars[i:].ctypes.data,
                          min(MAX_GROUPS, len(ptrs) - i), coefs.ctypes.data)
            launches += 1
        if hasattr(params, "_replace"):
            return params._replace(**leaves), new_state
        return leaves, new_state

    def update_reference(self, grads, state: dict, params, alive=None):
        """``update`` as plain tensor code, on any device: the dead-slot
        select as ``torch.where``, then Adam's out-of-place passes, the
        order of operations the kernel repeats."""
        f32 = np.float32
        grads = _leaves(grads)
        new_params = _leaves(params)
        new_state = {}
        for name, lr in self.lrs.items():
            g = grads[name]
            if g is None:
                g = torch.zeros_like(new_params[name])
            elif alive is not None:
                g = torch.where(alive.reshape((g.shape[0],)
                                              + (1,) * (g.ndim - 1)), g, 0.0)
            mu, nu, count = state[name]
            rate = lr(count) if callable(lr) else lr
            mu = (1 - self.b1) * g + self.b1 * mu
            nu = (1 - self.b2) * (g * g) + self.b2 * nu
            count += 1
            bc1 = float(f32(1) - f32(self.b1) ** f32(count))
            bc2 = float(f32(1) - f32(self.b2) ** f32(count))
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            new_params[name] = new_params[name] + float(f32(-rate)) * step
            new_state[name] = AdamGroup(mu, nu, count)
        if hasattr(params, "_replace"):
            return params._replace(**new_params), new_state
        return new_params, new_state


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _kernel_input(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    """``t`` as a contiguous float32 tensor of ``shape``, for the kernel."""
    if t.dtype != torch.float32 or t.shape != shape:
        raise ValueError(f"the Adam kernel takes float32 {name} of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def make_optimizer(opt: OptimizationParams, spatial_lr_scale: float) -> Adam:
    """The reference's per-group Adam; ``normals`` are frozen (no group)."""
    xyz_schedule = expon_lr_schedule(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )
    return Adam(lrs={
        "xyz": xyz_schedule,
        "features_dc": opt.feature_lr,
        "features_rest": opt.feature_lr / 20.0,
        "features": opt.feature_lr,
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
        "opacity": opt.opacity_lr,
    })
