"""Render API (port of the JAX package's ``gaussian_renderer``).

``render`` is the classic 3DGS render, differentiable through K1/K2.
``render_scaffold`` renders Scaffold-GS's anchors: their neural Gaussians,
decoded for the view, through the same rasterizer with precomputed
colours.
``render1``/``render2``/``render3`` are the fork's neural-feature paths: the
per-pixel z-buffer and feature map (``ops/idxmap.py``, kernel K3), then the
screen-space decoders of ``models/nets.py``. Under a profiler each opens the
span "ngs.render" and inside it "ngs.zbuffer", "ngs.decoders" and (render2
and render3) "ngs.denoise".
"""

from __future__ import annotations

import dataclasses

import torch

from neuralgaussiansplatting_torch import resolve_device
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.models import nets
from neuralgaussiansplatting_torch.models import scaffold
from neuralgaussiansplatting_torch.ops import idxmap as idxmap_ops
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops import sh as sh_ops
from neuralgaussiansplatting_torch.ops.preprocess import CameraParams
from neuralgaussiansplatting_torch.utils import timing


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
    with timing.span("ngs.render"):
        if scaling_modifier != 1.0:
            settings = dataclasses.replace(settings,
                                           scale_modifier=scaling_modifier)

        colors_precomp = override_color
        if override_color is None and convert_shs_python:
            colors_precomp = sh_ops.sh_to_rgb_color(
                active_sh_degree, gm.get_features(params), params.xyz,
                cam.campos)
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


def render_scaffold(cam: CameraParams, view: int,
                    params: scaffold.ScaffoldParams, nets: dict,
                    bg_color: torch.Tensor,
                    settings: rast.RasterizeSettings, anchor_capacity: int):
    """Render Scaffold-GS's anchors (``models/scaffold.py``) from ``cam``,
    the training camera ``view`` choosing the appearance embedding's row.

    Under the span "ngs.render": "ngs.anchors", the visibility prefilter
    (one preprocess launch over the anchors on the card) and the visible
    anchors gathered on the device into ``anchor_capacity`` rows
    (``scaffold.compact``); "ngs.generate", the MLPs, the expansion into
    ``N_OFFSETS`` neural Gaussians a row and the gate, as dead slots
    (opacity 0); then ``rast.rasterize`` with the colours precomputed (its
    own spans). Nothing is read back to the host.

    Returns a dict: "render" (3, H, W), "generated" (``scaffold.Generated``),
    "rows" (the anchor of each decoded row), "visible" (the rows'
    visibility), "visible_anchors" and "neural_gaussians" (device counts
    of the visible anchors and the kept Gaussians), "anchor_overflow" (the
    visible anchors left out of the rows), and the binning monitors of
    ``render``.
    """
    with timing.span("ngs.render"):
        with timing.span("ngs.anchors"):
            visible = scaffold.visible_anchors(cam, params, settings.block_x,
                                               settings.block_y)
            rows, count = scaffold.compact(visible, anchor_capacity)
            params = scaffold.ScaffoldParams(
                *(t.index_select(0, rows) for t in params))
            visible = torch.arange(rows.shape[0], device=rows.device) < count
        with timing.span("ngs.generate"):
            g = scaffold.generate(cam.campos, view, params, nets, visible)
        out = rast.rasterize(
            means3d=g.xyz, scales=g.scaling, rotations=g.rotation,
            opacities=g.opacity, shs=None, sh_degree=0, cam=cam, bg=bg_color,
            settings=settings, colors_precomp=g.color)
        return {
            "render": out.color,
            "generated": g,
            "rows": rows,
            "visible": visible,
            "visible_anchors": visible.sum(),
            "neural_gaussians": g.gate.sum(),
            "anchor_overflow": (count - rows.shape[0]).clamp_min(0),
            "radii": out.radii,
            "num_rendered": out.num_rendered,
            "max_per_tile": out.max_per_tile,
            "aligned_demand": out.aligned_demand,
            "dropped": out.dropped,
        }


# ---------------------------------------------------------------------------
# Neural-feature render paths (the fork's render1/render2/render3)
# ---------------------------------------------------------------------------

def init_decoders(seed: int | torch.Generator = 0, device="cuda") -> dict:
    """The screen-space decoders at the reference's widths, as float32
    modules on ``device``: {"mlp", "unet", "cnn", "pure_cnn"} (the
    reference's ``GaussianModel._init_networks``; the denoiser has no
    parameters). Weights are drawn by ``nets.kaiming_init_`` from ``seed``
    (an int, or a CPU ``torch.Generator``), in that order, so one seed gives
    the same decoders on every device."""
    dev = resolve_device(device)
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator().manual_seed(int(seed)))
    with torch.device("meta"):      # no throwaway default initialisation
        decoders = {"mlp": nets.FeatureToRGBMLP(), "unet": nets.UNet(),
                    "cnn": nets.CNN(), "pure_cnn": nets.PureCNN()}
    return {name: nets.kaiming_init_(m.to_empty(device=dev), gen)
            for name, m in decoders.items()}


def _neural_outputs(params, maps, final, **extra):
    """The return dict of the neural paths. ``radii`` is the reference's
    all-ones placeholder and visibility is idxmap > 0, which leaves out the
    Gaussian with id 0, as the reference does."""
    n = params.xyz.shape[0]
    return {
        "render": final.permute(2, 0, 1),
        **extra,
        "viewspace_points": params.xyz.new_zeros((n, 2)),
        "num_inst": maps.num_inst,
        "idxmap": maps.idxmap,
        "colmap": maps.colmap,
        "depthmap": maps.depthmap,
        "featuremap": maps.featuremap,
        "visibility_filter": maps.idxmap > 0,
        "radii": torch.ones(n, dtype=torch.int32, device=params.xyz.device),
    }


def render1(cam: CameraParams, params: gm.GaussianParams, net_params: dict,
            capacity: int = 1 << 21, dtype=torch.float32, alive=None):
    """idxmap -> per-pixel MLP (the reference's render1). ``net_params``
    holds the decoders (``init_decoders``); ``capacity`` counts the
    z-buffer's tile instances; ``dtype`` is the decoders' compute type."""
    with timing.span("ngs.render"):
        with timing.span("ngs.zbuffer"):
            maps = idxmap_ops.render_idxmaps(params.xyz, params.features,
                                             cam, capacity, alive)
        with timing.span("ngs.decoders"):
            final = net_params["mlp"](maps.featuremap, dtype)
        return _neural_outputs(params, maps, final)


def render2(cam: CameraParams, params: gm.GaussianParams, net_params: dict,
            capacity: int = 1 << 21, dtype=torch.float32, alive=None):
    """idxmap -> UNet RGB and CNN 9x9 kernels -> denoiser (the reference's
    render2); the UNet's RGB is returned as "aggregation" (H, W, 3)."""
    with timing.span("ngs.render"):
        with timing.span("ngs.zbuffer"):
            maps = idxmap_ops.render_idxmaps(params.xyz, params.features,
                                             cam, capacity, alive)
        with timing.span("ngs.decoders"):
            kernels = net_params["cnn"](maps.featuremap, dtype)
            unet_out = net_params["unet"](maps.featuremap, dtype)
        with timing.span("ngs.denoise"):
            final = nets.denoise(unet_out, kernels)
        return _neural_outputs(params, maps, final, aggregation=unet_out,
                               denoiser=kernels)


def render3(cam: CameraParams, params: gm.GaussianParams, net_params: dict,
            capacity: int = 1 << 21, dtype=torch.float32, alive=None):
    """idxmap -> MLP aggregation and CNN kernels -> denoiser (the
    reference's render3)."""
    with timing.span("ngs.render"):
        with timing.span("ngs.zbuffer"):
            maps = idxmap_ops.render_idxmaps(params.xyz, params.features,
                                             cam, capacity, alive)
        with timing.span("ngs.decoders"):
            aggregation = net_params["mlp"](maps.featuremap, dtype)
            kernels = net_params["cnn"](maps.featuremap, dtype)
        with timing.span("ngs.denoise"):
            final = nets.denoise(aggregation, kernels)
        return _neural_outputs(params, maps, final, aggregation=aggregation,
                               denoiser=kernels)
