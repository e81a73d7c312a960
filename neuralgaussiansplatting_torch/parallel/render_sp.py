"""Strip-parallel rendering: one frame's rows split over ranks.

Port of ``parallel/render_sp.py``. A frame is cut into horizontal strips,
each rendered by the unchanged ``render``; the Gaussians are replicated,
and the only traffic between ranks is the gather of the strips into the
frame. A strip is pure camera arithmetic, an asymmetric frustum: the
projection's y row becomes a * P_y + b * P_w, so the strip's NDC range maps
onto its rows of the frame; tan_fovy scales by strip_h / H, so the EWA
focal length is unchanged; and the full frame's frustum-clamp limits are
carried. With strips a whole number of tiles high, every strip bins as
its rows of the monolithic render do (binning culls on an absolute grid).
The pixels are not bit-equal: a strip's float32 projection row rounds each
Gaussian's pixel row apart from the full frame's by an ulp or two (every
other preprocess output is bit-equal), and each blend moves with it, more
for small, sharp splats; JAX's test holds a 48x64 frame to 1e-5.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.ops.preprocess import CameraParams


def strip_cameras(cam: CameraParams, n_strips: int) -> CameraParams:
    """``cam`` split into ``n_strips`` equal horizontal strips, stacked
    (``CameraParams.camera(s)`` is strip s). The projection rows are
    combined in float32 on the host, as the JAX package combines them."""
    h_full = cam.height
    if h_full % n_strips:
        raise ValueError(f"the frame's {h_full} rows do not split into "
                         f"{n_strips} strips: pad the frame height to the "
                         f"strip count")
    h = h_full // n_strips
    fp = cam.full_proj.cpu().numpy().astype(np.float32)
    projs = []
    for s in range(n_strips):
        y0 = s * h
        a = h_full / h
        b = (h_full - 2 * y0 - h) / h
        m = fp.copy()
        m[1] = a * fp[1] + b * fp[3]
        projs.append(m)
    # copies, not broadcast views: a strip's view matrix must be laid out
    # as the frame's, or the projection's matrix products may round apart
    return CameraParams(
        view=cam.view.expand(n_strips, 4, 4).contiguous(),
        full_proj=torch.from_numpy(np.stack(projs)),
        campos=cam.campos.expand(n_strips, 3).contiguous(),
        tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy * h / h_full,
        width=cam.width, height=h, limit_x=cam.limit_x, limit_y=cam.limit_y,
        device=cam.view.device)


def _render_rows(cams: CameraParams, strips, params, alive, sh_degree, bg,
                 settings) -> torch.Tensor:
    if cams.height % settings.block_y:
        raise ValueError(f"a strip of {cams.height} rows is not a whole "
                         f"number of {settings.block_y}-row tiles")
    return torch.cat([render(cams.camera(s), params, alive, sh_degree, bg,
                             settings)["render"] for s in strips], dim=1)


def render_strips(cams: CameraParams, params, alive, sh_degree, bg,
                  settings) -> torch.Tensor:
    """Render every strip of ``cams`` (``strip_cameras``) in turn and stack
    them into the (3, H, W) frame. A strip must be a whole number of tiles
    high (``settings.block_y``)."""
    return _render_rows(cams, range(cams.view.shape[0]), params, alive,
                        sh_degree, bg, settings)


def make_sharded_renderer(mesh, *, sh_degree, settings, n_strips=None):
    """A full-frame renderer over the mesh's tile axis: ``call(cam, params,
    alive, bg)`` -> (3, H, W) on every rank of the tile group. Tile rank t
    renders strips t * k .. t * k + k - 1 (k = n_strips / n_tile, default
    1), and the tile group all-gathers them; a mesh of one tile rank
    renders every strip itself."""
    n_strips = n_strips or mesh.n_tile
    if n_strips % mesh.n_tile:
        raise ValueError(f"{n_strips} strips do not split over "
                         f"{mesh.n_tile} tile ranks")
    per = n_strips // mesh.n_tile

    def call(cam: CameraParams, params, alive, bg):
        cams = strip_cameras(cam, n_strips)
        t = mesh.tile_index
        mine = _render_rows(cams, range(t * per, (t + 1) * per), params,
                            alive, sh_degree, bg, settings).contiguous()
        if mesh.tile_group is None:
            return mine
        parts = [torch.empty_like(mine) for _ in range(mesh.n_tile)]
        dist.all_gather(parts, mine, group=mesh.tile_group)
        return torch.cat(parts, dim=1)

    return call
