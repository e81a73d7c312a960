"""Adaptive density control on capacity-padded tensors (clone, split, prune).

Port of ``train/densify.py``. Every per-Gaussian tensor is allocated at a
fixed capacity with an ``alive`` mask: a clone copies a candidate row into
a free (dead) slot, a split replaces the original row by one sample and
writes a second sample into a free slot, a prune clears the mask. Adam rows
written by a clone or a split are zeroed; nothing else of the optimizer
state moves, because slots never move. Free slots are the dead ones in
index order; when they run out the surplus candidates (the highest-indexed)
are skipped and the full demand is reported. Nothing here waits on the
device.

Kept from the reference on purpose: its densification postfix zeroes the
max screen radii before the prune reads them, so the screen-size prune
never fires; only the opacity and world-size prunes act.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from neuralgaussiansplatting_torch.models.gaussians import (
    GaussianParams, GaussianState, get_opacity, get_scaling,
)
from neuralgaussiansplatting_torch.ops.transforms import (
    inverse_sigmoid, quat_to_rotmat,
)
from neuralgaussiansplatting_torch.train.optim import AdamGroup


class DensifyReport(NamedTuple):
    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    num_alive: torch.Tensor
    demand: torch.Tensor  # clones + splits asked for, skipped ones included


def _row_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def _scatter_rows(dst: torch.Tensor, target: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """dst with dst[target[i]] = src[i] where target[i] < len(dst); a
    target equal to the capacity is dropped (written to a scratch row).
    The kept targets are distinct."""
    ext = torch.cat([dst, dst[:1]])
    return ext.index_put((target,), src)[:-1]


def _mark(target: torch.Tensor, capacity: int) -> torch.Tensor:
    """(capacity,) bool, True at the in-range entries of ``target``."""
    marks = torch.zeros(capacity + 1, dtype=torch.bool, device=target.device)
    return marks.index_put((target,), torch.ones_like(target, dtype=torch.bool)
                           )[:capacity]


def zero_moment_rows(opt_state: dict, written: torch.Tensor) -> dict:
    """Adam state with the mu and nu rows of ``written`` slots zeroed."""
    return {name: AdamGroup(
                torch.where(_row_mask(written, g.mu), 0.0, g.mu),
                torch.where(_row_mask(written, g.nu), 0.0, g.nu), g.count)
            for name, g in opt_state.items()}


def add_densification_stats(state: GaussianState, radii: torch.Tensor,
                            means2d_grad: torch.Tensor) -> GaussianState:
    """Accumulate the screen-space gradient norm and the max screen radius
    of every visible Gaussian."""
    visible = radii > 0
    gnorm = torch.linalg.vector_norm(means2d_grad[:, :2], dim=-1)
    return state._replace(
        max_radii2d=torch.where(
            visible, torch.maximum(state.max_radii2d, radii.float()),
            state.max_radii2d),
        xyz_gradient_accum=state.xyz_gradient_accum
        + torch.where(visible, gnorm, 0.0),
        denom=state.denom + visible.float(),
    )


def densify_and_prune(
    params: GaussianParams,
    state: GaussianState,
    opt_state: dict,
    generator: torch.Generator | None,
    max_grad: float,
    min_opacity: float,
    extent: float,
    use_size_prune: bool,
    percent_dense: float,
    noise: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """One density-control round: (params, state, opt_state, report).

    A split draws two standard-normal (P, D) samples, D the scales a row
    (3, or 2 for surfels), from ``generator`` (on the parameters' device)
    unless ``noise`` gives them.
    """
    capacity = params.xyz.shape[0]
    alive = state.alive

    grads = torch.where(state.denom > 0,
                        state.xyz_gradient_accum
                        / torch.clamp_min(state.denom, 1.0), 0.0)
    scal = get_scaling(params)
    smax = scal.amax(dim=-1)

    hot = alive & (grads >= max_grad)
    clone_mask = hot & (smax <= percent_dense * extent)
    split_mask = hot & (smax > percent_dense * extent)

    # free slots: the dead ones, in index order
    free_slots = torch.argsort(alive.to(torch.uint8), stable=True)
    num_free = capacity - alive.sum()

    clone_rank = torch.cumsum(clone_mask, 0) - 1
    clone_ok = clone_mask & (clone_rank < num_free)
    clone_target = torch.where(
        clone_ok, free_slots[torch.clamp(clone_rank, 0, capacity - 1)],
        capacity)

    n_clones = clone_ok.sum()
    split_rank = torch.cumsum(split_mask, 0) - 1
    split_ok = split_mask & (n_clones + split_rank < num_free)
    split_target = torch.where(
        split_ok,
        free_slots[torch.clamp(n_clones + split_rank, 0, capacity - 1)],
        capacity)

    # clone: candidate rows copied into free slots
    new_params = GaussianParams(*(_scatter_rows(a, clone_target, a)
                                  for a in params))

    # split: two N(mean, scale) samples rotated into world space; sample A
    # replaces the original row, sample B goes to a free slot; both take
    # scaling / (0.8 * 2). A surfel (two scales) samples in its tangent
    # plane: the third deviation is 0, as in 2D Gaussian Splatting.
    if noise is None:
        noise = tuple(torch.randn(scal.shape, generator=generator,
                                  device=scal.device) for _ in range(2))
    rot = quat_to_rotmat(params.rotation)
    pad = (0, 3 - scal.shape[-1])
    samp_a = params.xyz + torch.einsum("nij,nj->ni", rot,
                                       F.pad(noise[0] * scal, pad))
    samp_b = params.xyz + torch.einsum("nij,nj->ni", rot,
                                       F.pad(noise[1] * scal, pad))
    new_scaling = torch.log(scal / (0.8 * 2))

    split_src = params._replace(xyz=samp_b, scaling=new_scaling)
    new_params = GaussianParams(*(_scatter_rows(dst, split_target, src)
                                  for dst, src in zip(new_params, split_src)))
    new_params = new_params._replace(
        xyz=torch.where(_row_mask(split_ok, samp_a), samp_a, new_params.xyz),
        scaling=torch.where(_row_mask(split_ok, new_scaling), new_scaling,
                            new_params.scaling),
    )

    cloned_to = _mark(clone_target, capacity)
    split_to = _mark(split_target, capacity)
    alive = alive | cloned_to | split_to
    opt_state = zero_moment_rows(opt_state, cloned_to | split_to | split_ok)

    # prune (the screen-size test is left out: see the module docstring)
    prune = alive & (get_opacity(new_params, alive) < min_opacity)
    if use_size_prune:
        prune = prune | (alive & (get_scaling(new_params).amax(dim=-1)
                                  > 0.1 * extent))
    alive = alive & ~prune

    new_state = GaussianState(
        alive=alive, max_radii2d=torch.zeros_like(state.max_radii2d),
        xyz_gradient_accum=torch.zeros_like(state.xyz_gradient_accum),
        denom=torch.zeros_like(state.denom))
    report = DensifyReport(
        num_cloned=clone_ok.sum(),
        num_split=split_ok.sum(),
        num_pruned=prune.sum(),
        num_alive=alive.sum(),
        demand=clone_mask.sum() + split_mask.sum(),
    )
    return new_params, new_state, opt_state, report


def reset_opacity(params: GaussianParams, opt_state: dict):
    """Clamp every opacity to at most 0.01 and zero the opacity group's Adam
    moments."""
    new_op = inverse_sigmoid(torch.clamp_max(torch.sigmoid(params.opacity),
                                             0.01))
    group = opt_state["opacity"]
    opt_state = {**opt_state, "opacity": AdamGroup(
        torch.zeros_like(group.mu), torch.zeros_like(group.nu), group.count)}
    return params._replace(opacity=new_op), opt_state
