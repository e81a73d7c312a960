"""Quaternion / scaling / 3D-covariance math (port of ``ops/transforms.py``).

Batched over a leading N axis; quaternion layout is (w, x, y, z).
"""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """(N, 4) wxyz quaternions -> (N, 3, 3) rotation matrices."""
    if normalize:
        q = q / torch.sqrt(torch.clamp_min(
            torch.sum(q * q, dim=-1, keepdim=True), 1e-16))
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y),
            2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x),
            2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s)."""
    return quat_to_rotmat(q) * s[..., None, :]


def build_covariance_3d(scaling: torch.Tensor, scaling_modifier: float,
                        rotation: torch.Tensor) -> torch.Tensor:
    """(N, 3) scales + (N, 4) quats -> (N, 3, 3) world covariance L L^T."""
    L = build_scaling_rotation(scaling * scaling_modifier, rotation)
    return L @ L.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) symmetric -> (N, 6) packing (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def unstrip_symmetric(cov6: torch.Tensor) -> torch.Tensor:
    """(N, 6) packed -> (N, 3, 3) symmetric."""
    xx, xy, xz, yy, yz, zz = [cov6[..., i] for i in range(6)]
    return torch.stack(
        [torch.stack([xx, xy, xz], -1),
         torch.stack([xy, yy, yz], -1),
         torch.stack([xz, yz, zz], -1)],
        dim=-2,
    )


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))
