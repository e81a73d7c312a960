"""Spherical-harmonics evaluation (degrees 0..3) and RGB<->SH DC helpers.

Port of ``ops/sh.py``: same constants, same term order.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH at unit directions.

    ``sh`` is (..., K, C) or flat (..., K*3) coefficient-major
    ([l0 rgb, l1 rgb, ...]); ``dirs`` (..., 3). Returns (..., C) with no +0.5
    shift and no clamp (see ``sh_to_rgb_color``).
    """
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree must be in 0..3, got {deg}")
    if sh.ndim == dirs.ndim:          # flat coefficient-major layout
        def c(l):
            return sh[..., 3 * l:3 * l + 3]
    else:
        def c(l):
            return sh[..., l, :]
    result = SH_C0 * c(0)
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (
            result
            - SH_C1 * y * c(1)
            + SH_C1 * z * c(2)
            - SH_C1 * x * c(3)
        )
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * c(4)
                + SH_C2[1] * yz * c(5)
                + SH_C2[2] * (2.0 * zz - xx - yy) * c(6)
                + SH_C2[3] * xz * c(7)
                + SH_C2[4] * (xx - yy) * c(8)
            )
            if deg > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * c(9)
                    + SH_C3[1] * xy * z * c(10)
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * c(11)
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * c(12)
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * c(13)
                    + SH_C3[5] * z * (xx - yy) * c(14)
                    + SH_C3[6] * x * (xx - 3.0 * yy) * c(15)
                )
    return result


def sh_to_rgb_color(deg: int, sh: torch.Tensor, means: torch.Tensor,
                    campos: torch.Tensor) -> torch.Tensor:
    """(N, 3) view-dependent RGB: eval_sh + 0.5, clamped at 0."""
    dirs = means - campos[None, :]
    # the guard sits inside the sqrt, so a Gaussian exactly at the camera
    # gives a finite direction (and a finite gradient) instead of 0/0
    norm = torch.sqrt(torch.clamp_min(
        torch.sum(dirs * dirs, dim=-1, keepdim=True), 1e-16))
    dirs = dirs / norm
    return torch.clamp_min(eval_sh(deg, sh, dirs) + 0.5, 0.0)


def RGB2SH(rgb):
    return (rgb - 0.5) / SH_C0


def SH2RGB(sh):
    return sh * SH_C0 + 0.5
