"""Public differentiable rasterization API (preprocess -> bin -> blend ->
assemble).

Port of ``ops/rasterize.py``; gradients come from ``torch.autograd``.
Backends:

- ``"seq"``: 32x32 tiles, 128-wide chunks, blended by kernel K1 forward and
  K2 backward on a CUDA device (their plain versions on the CPU). A seq
  setting of any other tile or chunk shape takes the ``"pallas"`` route, as
  in the JAX package: K1/K2's layout is fixed, K4/K5 take any shape.
- ``"pallas"``: 16x16 tiles by default, any tile shape, blended by kernel K4
  forward and K5 backward (``ops/blend_pallas.py``) on a CUDA device.
- ``"xla"``: the plain scan oracle of ``ops/blend.py``, on any device,
  differentiated by autograd.

The route depends on the settings alone (``blend_route``), and
``blend_tiles`` runs it: both kernel routes through one autograd Function.
``rasterize_surfels`` renders 2D Gaussian Splatting's surfels through the
same stages and Function: the preprocess kernels' surfel variant, binning
without the conic cull, and the surfel blend kernels of 32x32 tiles
(``ops/surfel_blend.py``).
``blend_seq.launches`` and ``blend_pallas.launches`` show which kernel ran.
The preprocess before the blend runs its own kernels on every backend
(``preprocess.launches``, ``preprocess.bwd_launches``), except with
precomputed covariances or colours.

``means2d_offset`` shifts the projected centres by offset * (W/2, H/2)
pixels, the reference's screen-space densification convention: its
gradient is dL/d(pixel centre) * (W/2, H/2), the statistic densification
accumulates.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import blend
from neuralgaussiansplatting_torch.ops import blend_pallas
from neuralgaussiansplatting_torch.ops import blend_seq
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.ops import surfel_blend
from neuralgaussiansplatting_torch.utils import timing


@dataclasses.dataclass(frozen=True)
class RasterizeSettings:
    """Static rasterizer configuration (see the JAX package's field notes)."""

    block_x: int = 32
    block_y: int = 32
    capacity: int = 1 << 18        # instance expansion/sort domain
    max_per_tile: int = 1024       # per-tile blend cap
    chunk: int = 128               # binning alignment / blend chunk
    backend: str = "seq"           # "seq" (32x32, chunk 128: K1/K2; other
                                   # shapes take the pallas route) |
                                   # "pallas" (any tile shape: K4/K5) |
                                   # "xla" (scan oracle)
    scale_modifier: float = 1.0
    fast_sort: bool = False        # packed [tile|depth] sort key
    tight_culling: bool = False    # opacity-adaptive per-axis rects
    track_contrib: bool = True     # False => n_contrib output is zeros
    packed_capacity: int | None = None  # aligned output buffer; None =>
                                        # capacity
    precise_cull: bool = True      # per-instance diagonal coverage cull
    expand: str = "scatter"        # "scatter" | "dense" | "auto" (=
                                   # scatter) instance expansion
    dense_cap: int = 16            # per-gaussian slot cap in dense mode

    def tiles_for(self, width: int, height: int):
        return (
            (width + self.block_x - 1) // self.block_x,
            (height + self.block_y - 1) // self.block_y,
        )


def make_settings(backend: str = "seq", **kw) -> RasterizeSettings:
    """Backend-appropriate settings: seq takes 32x32 tiles and 128-wide
    chunks; the others 16x16 tiles, with chunk 128 for pallas and 32 for the
    scan oracle."""
    if backend == "seq":
        kw.setdefault("block_x", 32)
        kw.setdefault("block_y", 32)
        kw.setdefault("chunk", 128)
    else:
        kw.setdefault("block_x", 16)
        kw.setdefault("block_y", 16)
        kw.setdefault("chunk", 128 if backend == "pallas" else 32)
    return RasterizeSettings(backend=backend, **kw)


class RenderOutput(NamedTuple):
    color: torch.Tensor          # (3, H, W) composited image
    final_t: torch.Tensor        # (H, W)
    n_contrib: torch.Tensor      # (H, W) int32
    radii: torch.Tensor          # (N,) int32 (0 => culled)
    num_rendered: torch.Tensor   # () int32 true instance count
    max_per_tile: torch.Tensor   # () int32 max true per-tile load
    aligned_demand: torch.Tensor  # () int32 packed-buffer demand
    dropped: torch.Tensor        # () int32 instances lost to caps/truncation
    culled: torch.Tensor         # () int32 instances removed by precise cull


def blend_route(settings: RasterizeSettings) -> str:
    """The blend ``rasterize`` runs for ``settings``: "seq" (K1/K2) for
    32x32 tiles with chunk 128, "pallas" (K4/K5) for backend "pallas" and
    every other seq shape, "xla" for the scan oracle. Raises ValueError for
    an unknown backend."""
    backend = settings.backend
    if backend not in ("seq", "pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "seq" and (settings.block_x, settings.block_y,
                             settings.chunk) != (32, 32, 128):
        return "pallas"
    return backend


class _SeqBlend(torch.autograd.Function):
    """A kernel route's forward wrapper ``fwd``, and its backward wrapper
    ``bwd`` masked by ``valid``, both called with the keywords ``kw``: the
    JAX ``custom_vjp`` of the kernel blends (raw outputs in, per-slot
    gradient rows out). Named for the main path's route: the benchmark's
    stage tests read its node as ``_SeqBlendBackward``."""

    @staticmethod
    def forward(ctx, packed, tile_start, tile_count, valid, fwd, bwd, kw):
        raw = fwd(packed, tile_start, tile_count, **kw)
        ctx.save_for_backward(packed, raw, tile_start, tile_count, valid)
        ctx.bwd, ctx.kw = bwd, kw
        return raw

    @staticmethod
    def backward(ctx, cot):
        packed, raw, tile_start, tile_count, valid = ctx.saved_tensors
        grad = ctx.bwd(packed, tile_start, tile_count, raw, cot.contiguous(),
                       **ctx.kw)
        grad = torch.where(valid[None, :], grad, 0.0)
        return grad, None, None, None, None, None, None


def blend_tiles(inst: binning.Instances, means2d: torch.Tensor,
                conic: torch.Tensor, opacity: torch.Tensor, rgb: torch.Tensor,
                tiles_x: int, tiles_y: int,
                settings: RasterizeSettings) -> blend.BlendResult:
    """Blend the binned instances by the route of ``settings``
    (``blend_route``), with ``blend.blend_tiles``' contract.

    The kernel routes gather the packed table by ``gid`` and run K1 and K2
    ("seq") or K4 and K5 ("pallas"), their plain versions on the CPU;
    binning has already applied ``max_per_tile`` and the chunk.
    ``track_contrib=False`` leaves n_contrib zero; the gradient is the
    same, but the backward then walks every instance of a tile.
    """
    route = blend_route(settings)
    if route == "xla":
        return blend.blend_tiles(
            inst, means2d, conic, opacity, rgb, tiles_x, tiles_y,
            settings.block_x, settings.block_y, settings.max_per_tile,
            settings.chunk)
    if inst.tile_start.shape[0] != tiles_x * tiles_y:
        raise ValueError(f"{inst.tile_start.shape[0]} tiles binned, "
                         f"{tiles_x * tiles_y} expected")
    kw = dict(tiles_x=tiles_x, track_contrib=settings.track_contrib)
    if route == "seq":
        fwd, bwd = blend_seq.blend_seq_fwd, blend_seq.blend_seq_bwd
    else:
        fwd, bwd = blend_pallas.blend_pallas_fwd, blend_pallas.blend_pallas_bwd
        kw.update(block_x=settings.block_x, block_y=settings.block_y)
    packed = blend.pack_gather(
        blend.pack_instance_attrs_t(means2d, conic, opacity, rgb), inst.gid)
    raw = _SeqBlend.apply(packed, inst.tile_start, inst.tile_count,
                          inst.valid, fwd, bwd, kw)
    return blend.BlendResult(color=raw[:, 0:3].transpose(1, 2),
                             final_t=raw[:, 3],
                             n_contrib=raw[:, 4].detach().to(torch.int32))


def mark_visible(means3d: torch.Tensor, cam: pp.CameraParams) -> torch.Tensor:
    """Frustum visibility: view-space z > 0.2."""
    p_view = proj.transform_points_4x3(means3d, cam.view)
    return p_view[..., 2] > 0.2


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    sh_degree: int,
    cam: pp.CameraParams,
    bg: torch.Tensor,
    settings: RasterizeSettings = RasterizeSettings(),
    means2d_offset: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
) -> RenderOutput:
    """Render N Gaussians for one camera.

    ``opacities`` (N,) and ``scales`` (N, 3) are activated; ``shs`` is
    (N, K, 3) or flat (N, 3K); ``bg`` (3,).
    """
    tiles_x, tiles_y = settings.tiles_for(cam.width, cam.height)

    with timing.span("ngs.preprocess"):
        pre = pp.preprocess_gaussians(
            means3d, scales, rotations, opacities, shs, sh_degree, cam,
            settings.block_x, settings.block_y, settings.scale_modifier,
            cov3d_precomp=cov3d_precomp, colors_precomp=colors_precomp,
            tight=settings.tight_culling, means2d_offset=means2d_offset,
        )

    with timing.span("ngs.binning"):
        inst = binning.bin_gaussians(
            pre, tiles_x, tiles_y, settings.capacity, settings.max_per_tile,
            settings.chunk, pack_keys=settings.fast_sort,
            packed_capacity=settings.packed_capacity,
            precise_cull=settings.precise_cull,
            block_x=settings.block_x, block_y=settings.block_y,
            width=cam.width, height=cam.height,
            # "auto" is the run-length scatter expansion at every size, as
            # in the JAX package
            expand="scatter" if settings.expand == "auto" else settings.expand,
            dense_cap=settings.dense_cap)

    def assemble(per_tile):
        return blend.assemble_image(
            per_tile, tiles_x, tiles_y, settings.block_x, settings.block_y,
            cam.width, cam.height)

    with timing.span("ngs.blend"):
        res = blend_tiles(inst, pre.means2d, pre.conic, pre.opacity,
                          pre.rgb, tiles_x, tiles_y, settings)
        color = res.color + res.final_t[..., None] * bg[None, None, :]
        return RenderOutput(
            color=assemble(color).permute(2, 0, 1),
            final_t=assemble(res.final_t),
            n_contrib=assemble(res.n_contrib),
            radii=pre.radii,
            num_rendered=inst.num_rendered,
            max_per_tile=inst.max_tile_load,
            aligned_demand=inst.aligned_demand,
            dropped=inst.dropped,
            culled=inst.culled,
        )


class SurfelRenderOutput(NamedTuple):
    color: torch.Tensor          # (3, H, W) composited image
    alpha: torch.Tensor          # (H, W) 1 - final T
    normal: torch.Tensor         # (3, H, W) view-space normal sum
    depth: torch.Tensor          # (H, W) depth sum (sum w z)
    median: torch.Tensor         # (H, W) median depth, 0 where none
    dist: torch.Tensor           # (H, W) distortion sum
    final_t: torch.Tensor        # (H, W)
    n_contrib: torch.Tensor      # (H, W) int32
    radii: torch.Tensor          # (N,) int32 (0 => culled)
    num_rendered: torch.Tensor
    max_per_tile: torch.Tensor
    aligned_demand: torch.Tensor
    dropped: torch.Tensor
    culled: torch.Tensor


def rasterize_surfels(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor | None,
    sh_degree: int,
    cam: pp.CameraParams,
    bg: torch.Tensor,
    settings: RasterizeSettings = RasterizeSettings(),
    means2d_offset: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
) -> SurfelRenderOutput:
    """Render N surfels (2D Gaussian Splatting) for one camera: ``scales``
    (N, 2) and ``opacities`` (N,) activated, the rest as ``rasterize``.

    The preprocess's surfel variant (``preprocess.preprocess_surfels``),
    then binning of each surfel's square rect without the per-instance
    conic cull (a surfel has no conic; ``precise_cull`` and
    ``tight_culling`` are the 3DGS rasterizer's and are not read), then
    the surfel blend of 32x32 tiles (``surfel_blend``) through the kernel
    routes' autograd Function, then the maps assembled. Only the "seq"
    route's layout has surfel kernels: other settings raise ValueError.
    Spans "ngs.preprocess", "ngs.binning", "ngs.blend", as ``rasterize``.
    """
    if blend_route(settings) != "seq":
        raise ValueError("the surfel blend takes the seq route's 32x32 tiles "
                         "with chunk 128, not backend "
                         f"{settings.backend!r} at {settings.block_x}x"
                         f"{settings.block_y}, chunk {settings.chunk}")
    tiles_x, tiles_y = settings.tiles_for(cam.width, cam.height)
    with timing.span("ngs.preprocess"):
        pre = pp.preprocess_surfels(
            means3d, scales, rotations, opacities, shs, sh_degree, cam,
            settings.block_x, settings.block_y, settings.scale_modifier,
            colors_precomp=colors_precomp, means2d_offset=means2d_offset)
    with timing.span("ngs.binning"):
        inst = binning.bin_gaussians(
            pre, tiles_x, tiles_y, settings.capacity, settings.max_per_tile,
            settings.chunk, pack_keys=settings.fast_sort,
            packed_capacity=settings.packed_capacity, precise_cull=False,
            block_x=settings.block_x, block_y=settings.block_y,
            width=cam.width, height=cam.height,
            expand="scatter" if settings.expand == "auto" else settings.expand,
            dense_cap=settings.dense_cap)
    if inst.tile_start.shape[0] != tiles_x * tiles_y:
        raise ValueError(f"{inst.tile_start.shape[0]} tiles binned, "
                         f"{tiles_x * tiles_y} expected")

    def assemble(per_tile):
        return blend.assemble_image(
            per_tile, tiles_x, tiles_y, settings.block_x, settings.block_y,
            cam.width, cam.height)

    with timing.span("ngs.blend"):
        packed = blend.pack_gather(blend.pack_instance_attrs_t(
            pre.means2d, pre.transmat, pre.opacity, pre.rgb, pre.normal),
            inst.gid)
        raw = _SeqBlend.apply(packed, inst.tile_start, inst.tile_count,
                              inst.valid, surfel_blend.surfel_blend_fwd,
                              surfel_blend.surfel_blend_bwd,
                              dict(tiles_x=tiles_x))
        final_t = raw[:, 3]
        color = raw[:, 0:3].transpose(1, 2) + final_t[..., None] * bg
        return SurfelRenderOutput(
            color=assemble(color).permute(2, 0, 1),
            alpha=assemble(1.0 - final_t),
            normal=assemble(raw[:, 5:8].transpose(1, 2)).permute(2, 0, 1),
            depth=assemble(raw[:, 8]),
            median=assemble(raw[:, 12]),
            dist=assemble(raw[:, 11]),
            final_t=assemble(final_t),
            n_contrib=assemble(raw[:, 4].detach().to(torch.int32)),
            radii=pre.radii,
            num_rendered=inst.num_rendered,
            max_per_tile=inst.max_tile_load,
            aligned_demand=inst.aligned_demand,
            dropped=inst.dropped,
            culled=inst.culled,
        )
