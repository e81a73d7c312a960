"""Render API (port of the JAX package's ``gaussian_renderer``).

``render`` is the classic 3DGS forward render. The neural-feature paths
``render1``/``render2``/``render3`` belong to a later slice of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops import sh as sh_ops
from neuralgaussiansplatting_torch.ops.preprocess import CameraParams


def render(
    cam: CameraParams,
    params: gm.GaussianParams,
    alive: torch.Tensor,
    active_sh_degree: int,
    bg_color: torch.Tensor,
    settings: rast.RasterizeSettings = rast.RasterizeSettings(),
    scaling_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    override_color: torch.Tensor | None = None,
    convert_shs_python: bool = False,
    compute_cov3d_python: bool = False,
):
    """Render the Gaussians of ``params`` (dead slots masked by ``alive``).

    Returns a dict with the JAX ``render``'s keys: "render" (3, H, W),
    "viewspace_points", "visibility_filter", "radii", "final_t",
    "n_contrib" and the binning monitors. ``convert_shs_python`` /
    ``compute_cov3d_python`` compute SH->RGB / the 3D covariance in the
    model layer and pass them in precomputed.
    """
    if scaling_modifier != 1.0:
        settings = dataclasses.replace(settings,
                                       scale_modifier=scaling_modifier)

    colors_precomp = override_color
    if override_color is None and convert_shs_python:
        colors_precomp = sh_ops.sh_to_rgb_color(
            active_sh_degree, gm.get_features(params), params.xyz, cam.campos)
    cov3d_precomp = None
    if compute_cov3d_python:
        cov3d_precomp = gm.get_covariance(params, scaling_modifier)

    out = rast.rasterize(
        means3d=params.xyz,
        scales=gm.get_scaling(params),
        rotations=gm.get_rotation(params),
        opacities=gm.get_opacity(params, alive),
        shs=gm.get_features(params),
        sh_degree=active_sh_degree,
        cam=cam,
        bg=bg_color,
        settings=settings,
        means2d_offset=means2d_offset,
        colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
    )
    n = params.xyz.shape[0]
    return {
        "render": out.color,
        "viewspace_points": (means2d_offset if means2d_offset is not None
                             else params.xyz.new_zeros((n, 2))),
        "visibility_filter": out.radii > 0,
        "radii": out.radii,
        "final_t": out.final_t,
        "n_contrib": out.n_contrib,
        "num_rendered": out.num_rendered,
        "max_per_tile": out.max_per_tile,
        "aligned_demand": out.aligned_demand,
        "dropped": out.dropped,
        "culled": out.culled,
    }
