"""Per-Gaussian screen-space preprocessing (project, EWA, SH->RGB, culling).

Port of ``ops/preprocess.py``. Culled Gaussians are not compacted; they
carry ``radii == 0`` and ``tiles_touched == 0`` and binning skips them.

``preprocess_gaussians`` is the public pass, differentiable through
``torch.autograd``. On CUDA tensors without precomputed covariances or
colours its forward is one kernel (``csrc/preprocess_fwd.cu``) and its
backward one kernel (``csrc/preprocess_bwd.cu``); ``launches`` and
``bwd_launches`` count them. On the CPU, and with either precomputed input,
it runs ``preprocess_gaussians_reference``, the plain version: dense
(N, ...) tensor arithmetic in the JAX package's operation order, which the
kernels repeat.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from neuralgaussiansplatting_torch import resolve_device
from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import projection as proj
from neuralgaussiansplatting_torch.ops import sh as sh_ops
from neuralgaussiansplatting_torch.ops import transforms

launches = 0      # forward kernel launches since the caller last set it to 0
bwd_launches = 0  # backward kernel launches since the caller last set it to 0

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# the C signatures of csrc/preprocess_{fwd,bwd}.cu (the last pointer is the
# stream)
_FWD_ARGS = (_P, _P, _P, _P, _P, _LL, _I, _P, _P, _P, _P, _LL, _F, _F, _F, _F,
             _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P,
             _P)
_BWD_ARGS = (_P, _P, _P, _P, _LL, _I, _P, _P, _P, _LL, _F, _F, _F, _F, _I, _I,
             _F, _P, _P, _P, _P, _P, _P, _P, _P, _P)


@dataclasses.dataclass(eq=False)
class CameraParams:
    """One camera: ``view`` and ``full_proj`` (4, 4) applied as ``M @ p``,
    ``campos`` (3,) the world-space centre, as float32 tensors on ``device``
    (numpy arrays or tensors are accepted). ``limit_x``/``limit_y`` are the
    EWA frustum-clamp limits, 1.3 * tan_fov unless given (a strip of a
    larger frame passes the full frame's)."""

    view: torch.Tensor
    full_proj: torch.Tensor
    campos: torch.Tensor
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int
    limit_x: float | None = None
    limit_y: float | None = None
    device: dataclasses.InitVar[str | torch.device] = "cuda"

    def __post_init__(self, device):
        dev = resolve_device(device)
        for name in ("view", "full_proj", "campos"):
            value = getattr(self, name)
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value, dtype=np.float32))
            setattr(self, name, value.to(device=dev, dtype=torch.float32))
        self.tan_fovx = float(self.tan_fovx)
        self.tan_fovy = float(self.tan_fovy)
        self.width = int(self.width)
        self.height = int(self.height)
        self.limit_x = (float(self.limit_x) if self.limit_x is not None
                        else 1.3 * self.tan_fovx)
        self.limit_y = (float(self.limit_y) if self.limit_y is not None
                        else 1.3 * self.tan_fovy)

    def camera(self, i: int) -> CameraParams:
        """Camera ``i`` of a stacked batch (``view`` (B, 4, 4),
        ``full_proj`` (B, 4, 4), ``campos`` (B, 3), as
        ``parallel.train_step.stack_cameras`` makes them): views of the
        batch's tensors, no copy."""
        return CameraParams(self.view[i], self.full_proj[i], self.campos[i],
                            self.tan_fovx, self.tan_fovy, self.width,
                            self.height, self.limit_x, self.limit_y,
                            device=self.view.device)


def _cov2d_components(means3d, scales, rotations, view, focal_x, focal_y,
                      limit_x, limit_y, scale_modifier):
    """quat + scale -> Sigma3D -> EWA 2D covariance, column by column.

    Same arithmetic as transforms.build_covariance_3d +
    projection.compute_cov2d; returns (cxx, cxy, cyy, tz).
    """
    q = rotations / torch.sqrt(torch.clamp_min(
        torch.sum(rotations * rotations, dim=-1, keepdim=True), 1e-16))
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R00 = 1 - 2 * (y * y + z * z)
    R01 = 2 * (x * y - r * z)
    R02 = 2 * (x * z + r * y)
    R10 = 2 * (x * y + r * z)
    R11 = 1 - 2 * (x * x + z * z)
    R12 = 2 * (y * z - r * x)
    R20 = 2 * (x * z - r * y)
    R21 = 2 * (y * z + r * x)
    R22 = 1 - 2 * (x * x + y * y)
    s2 = (scales * scale_modifier) ** 2
    s0, s1, s2_ = s2[:, 0], s2[:, 1], s2[:, 2]
    Sxx = R00 * R00 * s0 + R01 * R01 * s1 + R02 * R02 * s2_
    Sxy = R00 * R10 * s0 + R01 * R11 * s1 + R02 * R12 * s2_
    Sxz = R00 * R20 * s0 + R01 * R21 * s1 + R02 * R22 * s2_
    Syy = R10 * R10 * s0 + R11 * R11 * s1 + R12 * R12 * s2_
    Syz = R10 * R20 * s0 + R11 * R21 * s1 + R12 * R22 * s2_
    Szz = R20 * R20 * s0 + R21 * R21 * s1 + R22 * R22 * s2_

    W = view[:3, :3]
    tx_ = means3d @ W[0] + view[0, 3]
    ty_ = means3d @ W[1] + view[1, 3]
    tz_raw = means3d @ W[2] + view[2, 3]
    tz_ = torch.where(torch.abs(tz_raw) < 0.01,
                      torch.where(tz_raw < 0, -0.01, 0.01), tz_raw)
    txz = torch.clamp(tx_ / tz_, -limit_x, limit_x) * tz_
    tyz = torch.clamp(ty_ / tz_, -limit_y, limit_y) * tz_

    inv_z = 1.0 / tz_
    inv_z2 = inv_z * inv_z
    a0 = focal_x * inv_z
    c0 = -focal_x * txz * inv_z2
    b1 = focal_y * inv_z
    c1 = -focal_y * tyz * inv_z2
    T00 = a0 * W[0, 0] + c0 * W[2, 0]
    T01 = a0 * W[0, 1] + c0 * W[2, 1]
    T02 = a0 * W[0, 2] + c0 * W[2, 2]
    T10 = b1 * W[1, 0] + c1 * W[2, 0]
    T11 = b1 * W[1, 1] + c1 * W[2, 1]
    T12 = b1 * W[1, 2] + c1 * W[2, 2]

    u0 = T00 * Sxx + T01 * Sxy + T02 * Sxz
    u1 = T00 * Sxy + T01 * Syy + T02 * Syz
    u2 = T00 * Sxz + T01 * Syz + T02 * Szz
    v0 = T10 * Sxx + T11 * Sxy + T12 * Sxz
    v1 = T10 * Sxy + T11 * Syy + T12 * Syz
    v2 = T10 * Sxz + T11 * Syz + T12 * Szz
    cxx = u0 * T00 + u1 * T01 + u2 * T02 + 0.3
    cxy = u0 * T10 + u1 * T11 + u2 * T12
    cyy = v0 * T10 + v1 * T11 + v2 * T12 + 0.3
    return cxx, cxy, cyy, tz_


class Preprocessed(NamedTuple):
    means2d: torch.Tensor        # (N, 2) pixel-space centers
    depths: torch.Tensor         # (N,) view-space z
    radii: torch.Tensor          # (N,) int32, 0 => culled
    conic: torch.Tensor          # (N, 3) inverse 2D covariance (A, B, C)
    opacity: torch.Tensor        # (N,) activated opacity
    rgb: torch.Tensor            # (N, 3) view-dependent color
    rect_min: torch.Tensor       # (N, 2) int32 tile rect (x, y), inclusive
    rect_max: torch.Tensor       # (N, 2) int32 tile rect, exclusive
    tiles_touched: torch.Tensor  # (N,) int32


def preprocess_gaussians_reference(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    sh_degree: int,
    cam: CameraParams,
    block_x: int,
    block_y: int,
    scale_modifier: float = 1.0,
    cov3d_precomp: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
    tight: bool = False,
    means2d_offset: torch.Tensor | None = None,
) -> Preprocessed:
    """Plain PyTorch version of ``preprocess_gaussians``, on any device:
    the tensor code the kernels repeat, differentiated by autograd."""
    n = means3d.shape[0]
    tiles_x = (cam.width + block_x - 1) // block_x
    tiles_y = (cam.height + block_y - 1) // block_y

    p_view = proj.transform_points_4x3(means3d, cam.view)
    depths = p_view[..., 2]
    in_front = depths > 0.2

    p_ndc = proj.project_points(means3d, cam.full_proj)
    means2d = torch.stack(
        [proj.ndc2pix(p_ndc[..., 0], cam.width),
         proj.ndc2pix(p_ndc[..., 1], cam.height)],
        dim=-1,
    )

    focal_x = cam.width / (2.0 * cam.tan_fovx)
    focal_y = cam.height / (2.0 * cam.tan_fovy)
    if cov3d_precomp is not None:
        cov3d = transforms.unstrip_symmetric(cov3d_precomp)
        cov2d = proj.compute_cov2d(
            means3d, cov3d, cam.view, focal_x, focal_y, cam.tan_fovx,
            cam.tan_fovy, cam.limit_x, cam.limit_y,
        )
    else:
        cxx, cxy, cyy, _ = _cov2d_components(
            means3d, scales, rotations, cam.view, focal_x, focal_y,
            cam.limit_x, cam.limit_y, scale_modifier)
        cov2d = torch.stack([cxx, cxy, cyy], dim=-1)
    conic, radius, det = proj.conic_and_radius(cov2d)

    # radii and validity always use the square 3-sigma rect
    rect_min, rect_max = proj.tile_rect(
        means2d, radius, tiles_x, tiles_y, block_x, block_y)
    rect_w = rect_max[..., 0] - rect_min[..., 0]
    rect_h = rect_max[..., 1] - rect_min[..., 1]

    # near plane, det == 0, empty rect; plus exactly-zero opacity, which is
    # what dead capacity-padding slots carry
    valid = (in_front & (det != 0.0) & (rect_w * rect_h > 0)
             & (opacities > 0.0))
    radii = torch.where(valid, radius, 0.0).to(torch.int32)

    if tight:
        # Opacity-adaptive per-axis extents: outside the alpha = 1/255 level
        # set's bounding box every pixel contributes exactly zero, so the
        # square rect is intersected with that box (image-exact).
        two_l = 2.0 * torch.log(torch.clamp_min(opacities, 1e-12) * 255.0)
        pos = two_l > 0.0
        two_l = torch.clamp_min(two_l, 0.0)
        ext_x = torch.where(
            pos, torch.minimum(radius, torch.ceil(
                torch.sqrt(torch.clamp_min(two_l * cov2d[..., 0], 0.0)))),
            0.0)
        ext_y = torch.where(
            pos, torch.minimum(radius, torch.ceil(
                torch.sqrt(torch.clamp_min(two_l * cov2d[..., 2], 0.0)))),
            0.0)
        x, y = means2d[..., 0], means2d[..., 1]

        def clip(v, hi):
            return torch.clamp(v, 0, hi).to(torch.int32)

        tmin_x = torch.maximum(rect_min[..., 0], clip(
            torch.floor((x - ext_x) / block_x), tiles_x))
        tmin_y = torch.maximum(rect_min[..., 1], clip(
            torch.floor((y - ext_y) / block_y), tiles_y))
        tmax_x = torch.minimum(rect_max[..., 0], clip(
            torch.floor((x + ext_x) / block_x) + 1, tiles_x))
        tmax_y = torch.minimum(rect_max[..., 1], clip(
            torch.floor((y + ext_y) / block_y) + 1, tiles_y))
        rect_min = torch.stack([tmin_x, tmin_y], dim=-1)
        rect_max = torch.stack([tmax_x, tmax_y], dim=-1)
        rect_w = torch.clamp_min(tmax_x - tmin_x, 0)
        rect_h = torch.clamp_min(tmax_y - tmin_y, 0)
        tiles = torch.where(valid & pos, rect_w * rect_h, 0).to(torch.int32)
    else:
        tiles = torch.where(valid, rect_w * rect_h, 0).to(torch.int32)

    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        rgb = sh_ops.sh_to_rgb_color(sh_degree, shs, means3d, cam.campos)
    if rgb.shape != (n, 3):
        raise ValueError(f"colors must be ({n}, 3), got {tuple(rgb.shape)}")
    if means2d_offset is not None:
        # scaled column by column with Python scalars: a (2,) tensor made
        # from host values would be a blocking copy to the device
        shift = torch.stack([means2d_offset[:, 0] * (cam.width * 0.5),
                             means2d_offset[:, 1] * (cam.height * 0.5)], -1)
        means2d = means2d + shift
    return Preprocessed(
        means2d=means2d,
        depths=depths,
        radii=radii,
        conic=conic,
        opacity=opacities,
        rgb=rgb,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=tiles,
    )


def _camera_tensor(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"camera tensors must be on {device}, got {t.device}")
    return t.detach().contiguous()


def _floats(t: torch.Tensor, name: str, shape: tuple) -> torch.Tensor:
    """``t`` as a contiguous float32 tensor of ``shape``, 16-byte aligned
    for the kernels' float4 and float2 accesses (a view at an odd offset is
    copied)."""
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape} float32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _Preprocess(torch.autograd.Function):
    """The forward kernel and the backward kernel: means2d, conic and rgb
    differentiable in the means, scales, rotations, SH rows and offset; the
    depths, radii, rects and tile counts carry no gradient. Saves only its
    inputs: the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, shs, offset,
                view, full_proj, campos, meta):
        global launches
        (sh_degree, focal_x, focal_y, limit_x, limit_y, width, height,
         tiles_x, tiles_y, block_x, block_y, scale_modifier, tight) = meta
        n = means3d.shape[0]
        dev = means3d.device
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        means2d = torch.empty((n, 2), **f32)
        depths = torch.empty((n,), **f32)
        radii = torch.empty((n,), **i32)
        conic = torch.empty((n, 3), **f32)
        rgb = torch.empty((n, 3), **f32)
        rect_min = torch.empty((n, 2), **i32)
        rect_max = torch.empty((n, 2), **i32)
        tiles = torch.empty((n,), **i32)
        _build.launch(
            "preprocess_fwd", _FWD_ARGS, dev, means3d.data_ptr(),
            scales.data_ptr(), rotations.data_ptr(), opacities.data_ptr(),
            shs.data_ptr(), shs.shape[1], sh_degree, view.data_ptr(),
            full_proj.data_ptr(), campos.data_ptr(),
            None if offset is None else offset.data_ptr(), n, focal_x,
            focal_y, limit_x, limit_y, width, height, tiles_x, tiles_y,
            block_x, block_y, scale_modifier, int(tight), means2d.data_ptr(),
            depths.data_ptr(), radii.data_ptr(), conic.data_ptr(),
            rgb.data_ptr(), rect_min.data_ptr(), rect_max.data_ptr(),
            tiles.data_ptr())
        launches += 1
        ctx.save_for_backward(means3d, scales, rotations, shs, view,
                              full_proj, campos)
        ctx.meta = meta
        ctx.has_offset = offset is not None
        ctx.mark_non_differentiable(depths, radii, rect_min, rect_max, tiles)
        ctx.set_materialize_grads(False)
        return means2d, depths, radii, conic, rgb, rect_min, rect_max, tiles

    @staticmethod
    def backward(ctx, g_means2d, _depths, _radii, g_conic, g_rgb, *_ints):
        global bwd_launches
        means3d, scales, rotations, shs, view, full_proj, campos = \
            ctx.saved_tensors
        sh_degree, focal_x, focal_y, limit_x, limit_y, width, height = \
            ctx.meta[:7]
        scale_modifier = ctx.meta[11]
        n = means3d.shape[0]

        def upstream(g, cols):
            if g is None:
                return means3d.new_zeros((n, cols))
            return _floats(g, "the upstream gradient", (n, cols))

        g_means2d, g_conic, g_rgb = (upstream(g_means2d, 2),
                                     upstream(g_conic, 3),
                                     upstream(g_rgb, 3))
        g_means = torch.empty_like(means3d)
        g_scales = torch.empty_like(scales)
        g_rots = torch.empty_like(rotations)
        g_shs = torch.empty_like(shs)
        g_offset = (means3d.new_empty((n, 2)) if ctx.has_offset else None)
        _build.launch(
            "preprocess_bwd", _BWD_ARGS, means3d.device, means3d.data_ptr(),
            scales.data_ptr(), rotations.data_ptr(), shs.data_ptr(),
            shs.shape[1], sh_degree, view.data_ptr(), full_proj.data_ptr(),
            campos.data_ptr(), n, focal_x, focal_y, limit_x, limit_y, width,
            height, scale_modifier, g_means2d.data_ptr(), g_conic.data_ptr(),
            g_rgb.data_ptr(), g_means.data_ptr(), g_scales.data_ptr(),
            g_rots.data_ptr(), g_shs.data_ptr(),
            None if g_offset is None else g_offset.data_ptr())
        bwd_launches += 1
        return (g_means, g_scales, g_rots, None, g_shs, g_offset, None, None,
                None, None)


def takes_kernels(means3d: torch.Tensor,
                  cov3d_precomp: torch.Tensor | None = None,
                  colors_precomp: torch.Tensor | None = None) -> bool:
    """Whether ``preprocess_gaussians`` runs the kernels for these inputs:
    CUDA tensors and neither precomputed input."""
    return (means3d.device.type == "cuda" and cov3d_precomp is None
            and colors_precomp is None)


def preprocess_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    sh_degree: int,
    cam: CameraParams,
    block_x: int,
    block_y: int,
    scale_modifier: float = 1.0,
    cov3d_precomp: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
    tight: bool = False,
    means2d_offset: torch.Tensor | None = None,
) -> Preprocessed:
    """Preprocess N Gaussians for one camera.

    ``scales``/``opacities`` are already activated (exp / sigmoid); ``shs``
    is (N, K, 3) or flat (N, 3K), of which the first (sh_degree + 1)^2
    coefficients are read. ``means2d_offset`` (N, 2) shifts the projected
    centres by offset * (W/2, H/2) pixels after the tile rects are taken
    (the reference's screen-space densification statistic is its
    gradient). The kernels run where ``takes_kernels`` says, the plain
    version elsewhere; both give the same fields, the opacity being the
    input tensor itself.
    """
    if not takes_kernels(means3d, cov3d_precomp, colors_precomp):
        return preprocess_gaussians_reference(
            means3d, scales, rotations, opacities, shs, sh_degree, cam,
            block_x, block_y, scale_modifier, cov3d_precomp=cov3d_precomp,
            colors_precomp=colors_precomp, tight=tight,
            means2d_offset=means2d_offset)
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"SH degree must be in 0..3, got {sh_degree}")
    n = means3d.shape[0]
    dev = means3d.device
    flat = shs.reshape(n, -1) if shs.dim() == 3 else shs
    if (flat.dim() != 2 or flat.shape[1] % 3
            or flat.shape[1] < 3 * (sh_degree + 1) ** 2):
        raise ValueError(f"shs must hold (N, K, 3) coefficients with K >= "
                         f"{(sh_degree + 1) ** 2}, got {tuple(shs.shape)}")
    args = [_floats(means3d, "means3d", (n, 3)),
            _floats(scales, "scales", (n, 3)),
            _floats(rotations, "rotations", (n, 4)),
            _floats(opacities, "opacities", (n,)),
            _floats(flat, "shs", tuple(flat.shape)),
            None if means2d_offset is None
            else _floats(means2d_offset, "means2d_offset", (n, 2))]
    if any(a is not None and a.device != dev for a in args):
        raise ValueError("the inputs must be on one device")
    tiles_x = (cam.width + block_x - 1) // block_x
    tiles_y = (cam.height + block_y - 1) // block_y
    meta = (sh_degree, cam.width / (2.0 * cam.tan_fovx),
            cam.height / (2.0 * cam.tan_fovy), cam.limit_x, cam.limit_y,
            cam.width, cam.height, tiles_x, tiles_y, block_x, block_y,
            float(scale_modifier), bool(tight))
    (means2d, depths, radii, conic, rgb, rect_min, rect_max,
     tiles) = _Preprocess.apply(
        *args, _camera_tensor(cam.view, dev),
        _camera_tensor(cam.full_proj, dev), _camera_tensor(cam.campos, dev),
        meta)
    return Preprocessed(means2d=means2d, depths=depths, radii=radii,
                        conic=conic, opacity=opacities, rgb=rgb,
                        rect_min=rect_min, rect_max=rect_max,
                        tiles_touched=tiles)
