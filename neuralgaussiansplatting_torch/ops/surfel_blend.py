"""The surfel blend: the 32x32-tile blend of 2D Gaussian Splatting's
surfels, by ray-splat intersection, with the per-pixel outputs 2DGS trains
on.

``surfel_blend_fwd`` wraps the forward kernel (``csrc/surfel_blend_fwd.cu``)
and ``surfel_blend_bwd`` the backward kernel (``csrc/surfel_blend_bwd.cu``),
which share ``csrc/blend_common.cuh``'s tile staging and constants with K1
and K2: on a CUDA tensor each launches its kernel or raises ``ValueError``,
never falling back; on a CPU tensor each runs its plain PyTorch version
(``surfel_blend_fwd_reference``, ``surfel_blend_bwd_reference``), which
repeats the kernel's recurrence in its operation order. ``launches`` and
``bwd_launches`` count the launches. ``rasterize.rasterize_surfels``
differentiates through the pair.

The packed table (``blend.pack_instance_attrs_t`` of the centre, the
transform, the opacity, rgb and the normal) has ``SROWS`` rows: 0-1 the
centre of the surfel's 3-sigma box (x, y), 2-10 its transform's rows T_u,
T_v, T_w, 11 the opacity, 12-14 rgb, 15-17 the view-space normal. Per
(surfel, pixel) pair at pixel (x, y) (integer positions):

    k = x T_w - T_u, l = y T_w - T_v, c = k x l, (u, v) = (c.x, c.y) / c.z
    rho3d = u^2 + v^2; rho2d = 2 |centre - (x, y)|^2; rho = min of the two
    z = u T_w.x + v T_w.y + T_w.z where rho3d <= rho2d, else T_w.z
    alpha = min(0.99, op exp(-rho / 2)); skipped where c.z = 0, z < 0.2 or
    alpha < 1/255; the pixel stops as K1's does (T under 1e-4)

and front to back with weights w = alpha T the pixel's ``CHANNELS``
outputs: 0-2 rgb, 3 the final T, 4 n_contrib (1-based, as float), 5-7 the
normal sum w n, 8 the depth sum w z, 9 M1 = sum w m and 10 M2 = sum w m^2
(m = z mapped to NDC between 0.2 and 100), 11 the distortion sum w (m^2 A +
M2' - 2 m M1') (A = 1 - T, M1', M2' the sums before the pair), 12 the
median depth (the z of the last blended pair whose T before it is above
0.5; 0 where none) and 13 its 1-based index.

The backward re-walks the forward front to back, as K2 does, and takes
dL/dalpha from running prefixes: each output the pixel sums over its pairs
has a weight gradient g_w(pair) (rgb . g_rgb, n . g_n, z g_depth and, for
the distortion, g_dist (M2 + m^2 A - 2 m M1) with the pixel's totals), so

    dalpha = T g_w - (tot - prefix) / (1 - a),  tot = sum w g_w + T_f g_T

and the depth's gradient w g_depth + g_dist 2 w (m A - M1) dm/dz (+ the
median's where the pair is it) runs back through z and the intersection
to the transform, or to T_w.z and the filter's centre on the low-pass
side. Alpha's gradient is taken unclamped, as K2 and 2DGS's rasterizer
take it. The cotangent's rows 4, 9, 10 and 13 are not read.
"""

from __future__ import annotations

import ctypes

import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops.blend import (
    ALPHA_MAX, ALPHA_MIN, STOP_T, check_blend_inputs, tile_pixel_coords,
)

BX = BY = 32
PIX = BX * BY
SROWS = 18
CHANNELS = 14
NEAR, FAR = 0.2, 100.0
FILTER_INV_SQUARE = 2.0   # 1 / (sqrt(2) / 2)^2, the low-pass filter
MEDIAN_T = 0.5
# m = M_SCALE (1 - NEAR / z) maps a depth to NDC; dm/dz = DM_SCALE / z^2
M_SCALE = FAR / (FAR - NEAR)
DM_SCALE = FAR * NEAR / (FAR - NEAR)

launches = 0      # forward launches since the caller last set it to 0
bwd_launches = 0  # backward launches since the caller last set it to 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C signatures of csrc/surfel_blend_{fwd,bwd}.cu (the last pointer is
# the stream)
_FWD_ARGS = (_P, _P, _P, _LL, _I, _I, _P, _P)
_BWD_ARGS = (_P, _P, _P, _LL, _P, _P, _I, _I, _P, _P)


def _check(packed, tile_start, tile_count, tiles_x, *per_tile):
    check_blend_inputs(packed, tile_start, tile_count, tiles_x, PIX,
                       *per_tile, rows=SROWS, channels=CHANNELS)


def surfel_blend_fwd(packed: torch.Tensor, tile_start: torch.Tensor,
                     tile_count: torch.Tensor,
                     tiles_x: int) -> torch.Tensor:
    """Blend every 32x32 tile's surfels: (SROWS, K) packed instances ->
    (T, CHANNELS, 1024). Pixel p of a tile is at (p % 32, p // 32); tile
    t's instances are columns [tile_start[t], tile_start[t] +
    tile_count[t]) of ``packed``."""
    global launches
    _check(packed, tile_start, tile_count, tiles_x)
    if not _build.on_cuda("surfel_blend_fwd",
                          (packed, tile_start, tile_count),
                          "rasterize.rasterize_surfels"):
        return surfel_blend_fwd_reference(packed, tile_start, tile_count,
                                          tiles_x)
    num_tiles = tile_start.shape[0]
    out = torch.empty((num_tiles, CHANNELS, PIX), dtype=torch.float32,
                      device=packed.device)
    _build.launch("surfel_blend_fwd", _FWD_ARGS, packed.device,
                  tile_start.data_ptr(), tile_count.data_ptr(),
                  packed.data_ptr(), packed.shape[1], num_tiles, tiles_x,
                  out.data_ptr())
    launches += 1
    return out


def surfel_blend_bwd(packed: torch.Tensor, tile_start: torch.Tensor,
                     tile_count: torch.Tensor, raw: torch.Tensor,
                     cot: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """Backward of ``surfel_blend_fwd``: the (SROWS, K) gradient of
    ``packed`` from ``raw`` (the forward's output for the same inputs) and
    ``cot``, its cotangent. Slots past a tile's deepest contributor and
    past ``tile_count`` are zero."""
    global bwd_launches
    _check(packed, tile_start, tile_count, tiles_x, ("raw", raw),
           ("cot", cot))
    if not _build.on_cuda("surfel_blend_bwd",
                          (packed, tile_start, tile_count, raw, cot),
                          "rasterize.rasterize_surfels"):
        return surfel_blend_bwd_reference(packed, tile_start, tile_count,
                                          raw, cot, tiles_x)
    grad = torch.zeros_like(packed)
    _build.launch("surfel_blend_bwd", _BWD_ARGS, packed.device,
                  tile_start.data_ptr(), tile_count.data_ptr(),
                  packed.data_ptr(), packed.shape[1], raw.data_ptr(),
                  cot.data_ptr(), tile_start.shape[0], tiles_x,
                  grad.data_ptr())
    bwd_launches += 1
    return grad


class _Pair:
    """One instance index's pairs with a tile's 1024 pixels: the forward's
    quantities, in the kernels' operation order."""

    def __init__(self, attrs, px, py, t, done):
        (self.cx, self.cy, tu0, tu1, tu2, tv0, tv1, tv2, tw0, tw1, tw2,
         self.op, self.r, self.g, self.b, self.n0, self.n1,
         self.n2) = attrs[:, :, None]
        self.tu, self.tv, self.tw = (tu0, tu1, tu2), (tv0, tv1, tv2), (
            tw0, tw1, tw2)
        k = [px * self.tw[i] - self.tu[i] for i in range(3)]
        l_ = [py * self.tw[i] - self.tv[i] for i in range(3)]
        self.k, self.l = k, l_
        c0 = k[1] * l_[2] - k[2] * l_[1]
        c1 = k[2] * l_[0] - k[0] * l_[2]
        self.c2 = k[0] * l_[1] - k[1] * l_[0]
        safe = torch.where(self.c2 == 0.0, 1.0, self.c2)
        self.u = c0 / safe
        self.v = c1 / safe
        rho3d = self.u * self.u + self.v * self.v
        self.dx = self.cx - px
        self.dy = self.cy - py
        rho2d = FILTER_INV_SQUARE * (self.dx * self.dx + self.dy * self.dy)
        self.on3d = rho3d <= rho2d
        rho = torch.where(self.on3d, rho3d, rho2d)
        self.z = torch.where(self.on3d,
                             (self.u * tw0 + self.v * tw1) + tw2, tw2)
        power = -0.5 * rho
        self.gexp = torch.exp(power)
        self.opg = self.op * self.gexp
        alpha = torch.clamp_max(self.opg, ALPHA_MAX)
        self.a = torch.where(
            (self.c2 != 0.0) & (self.z >= NEAR) & (power <= 0.0)
            & (alpha >= ALPHA_MIN) & ~done, alpha, 0.0)
        ta = t * self.a
        self.t_new = t - ta
        self.blend = (self.a > 0.0) & (self.t_new >= STOP_T)
        self.stops = (self.a > 0.0) & (self.t_new < STOP_T)
        self.w = torch.where(self.blend, ta, 0.0)
        self.zb = torch.where(self.blend, self.z, 1.0)
        # a Python scalar over a tensor is its reciprocal times the scalar
        # in PyTorch, and so in the kernels
        self.m = M_SCALE * (1.0 - NEAR * (1.0 / self.zb))


def surfel_blend_fwd_reference(packed: torch.Tensor,
                               tile_start: torch.Tensor,
                               tile_count: torch.Tensor,
                               tiles_x: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (``surfel_blend_fwd``),
    on any device: a loop over instance index i < max(tile_count),
    vectorised over (tiles x 1024 px), in the kernel's operation order."""
    _check(packed, tile_start, tile_count, tiles_x)
    dev = packed.device
    num_tiles = tile_start.shape[0]
    px, py = tile_pixel_coords(tiles_x, num_tiles // tiles_x, BX, BY, dev)
    start, count = tile_start.long(), tile_count.long()
    t = torch.ones((num_tiles, PIX), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=dev)
    (cr, cg, cb, last, nx, ny, nz, depth, m1, m2, dist, med,
     med_i) = (torch.zeros_like(t) for _ in range(13))
    for i in range(int(count.max()) if num_tiles else 0):
        live = i < count
        col = torch.clamp(start + i, max=packed.shape[1] - 1)
        attrs = torch.where(live[None, :], packed[:, col], 0.0)
        p = _Pair(attrs, px, py, t, done)
        w, m = p.w, p.m
        dist = dist + ((((m * m) * (1.0 - t)) + m2) - (2.0 * m) * m1) * w
        depth = depth + p.zb * w
        m1 = m1 + m * w
        m2 = m2 + (m * m) * w
        mid = p.blend & (t > MEDIAN_T)
        med = torch.where(mid, p.z, med)
        med_i = torch.where(mid, float(i + 1), med_i)
        cr, cg, cb = cr + w * p.r, cg + w * p.g, cb + w * p.b
        nx, ny, nz = nx + w * p.n0, ny + w * p.n1, nz + w * p.n2
        last = torch.where(p.blend, float(i + 1), last)
        t = torch.where(p.blend, p.t_new, t)
        done = done | p.stops
    return torch.stack([cr, cg, cb, t, last, nx, ny, nz, depth, m1, m2, dist,
                        med, med_i], dim=1)


def surfel_blend_bwd_reference(packed: torch.Tensor,
                               tile_start: torch.Tensor,
                               tile_count: torch.Tensor, raw: torch.Tensor,
                               cot: torch.Tensor,
                               tiles_x: int) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel (``surfel_blend_bwd``),
    on any device: a loop over instance index i < a tile's deepest
    contributor, vectorised over (tiles x 1024 px), in the kernel's
    operation order; the sums run over the pixel axis."""
    _check(packed, tile_start, tile_count, tiles_x, ("raw", raw),
           ("cot", cot))
    dev = packed.device
    num_tiles = tile_start.shape[0]
    px, py = tile_pixel_coords(tiles_x, num_tiles // tiles_x, BX, BY, dev)
    start = tile_start.long()
    stop = torch.minimum(tile_count.long(), raw[:, 4].amax(dim=1).long())
    g_rgb, g_t = cot[:, 0:3], cot[:, 3]
    g_n, g_d, g_dist, g_med = cot[:, 5:8], cot[:, 8], cot[:, 11], cot[:, 12]
    a_tot = 1.0 - raw[:, 3]
    m1_tot, m2_tot, med_i = raw[:, 9], raw[:, 10], raw[:, 13]
    tot = ((((raw[:, 0] * g_rgb[:, 0] + raw[:, 1] * g_rgb[:, 1])
             + raw[:, 2] * g_rgb[:, 2]) + raw[:, 3] * g_t)
           + ((raw[:, 5] * g_n[:, 0] + raw[:, 6] * g_n[:, 1])
              + raw[:, 7] * g_n[:, 2])) + raw[:, 8] * g_d
    tot = tot + g_dist * ((a_tot * m2_tot + m2_tot * a_tot)
                          - (2.0 * m1_tot) * m1_tot)
    t = torch.ones((num_tiles, PIX), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=dev)
    prefix = torch.zeros_like(t)
    grad = torch.zeros_like(packed)
    for i in range(int(stop.max()) if num_tiles else 0):
        live = i < stop
        col = torch.clamp(start + i, max=packed.shape[1] - 1)
        attrs = torch.where(live[None, :], packed[:, col], 0.0)
        p = _Pair(attrs, px, py, t, done)
        w, m = p.w, p.m
        gw = ((((p.r * g_rgb[:, 0] + p.g * g_rgb[:, 1]) + p.b * g_rgb[:, 2])
               + ((p.n0 * g_n[:, 0] + p.n1 * g_n[:, 1]) + p.n2 * g_n[:, 2]))
              + p.zb * g_d) + g_dist * ((((m * m) * a_tot) + m2_tot)
                                        - (2.0 * m) * m1_tot)
        prefix = prefix + w * gw
        dalpha = t * gw - (tot - prefix) / (1.0 - p.a)
        gz = (w * g_d + (g_dist * ((2.0 * w) * (m * a_tot - m1_tot)))
              * (DM_SCALE * (1.0 / (p.zb * p.zb))))
        gz = gz + torch.where(med_i == float(i + 1), g_med, 0.0)
        grho = -0.5 * (p.opg * dalpha)
        # the intersection's side
        gu = grho * (2.0 * p.u) + gz * p.tw[0]
        gv = grho * (2.0 * p.v) + gz * p.tw[1]
        safe = torch.where(p.c2 == 0.0, 1.0, p.c2)
        gc = (gu / safe, gv / safe, -(gu * p.u + gv * p.v) / safe)
        k, l_ = p.k, p.l
        gk = (l_[1] * gc[2] - l_[2] * gc[1], l_[2] * gc[0] - l_[0] * gc[2],
              l_[0] * gc[1] - l_[1] * gc[0])
        gl = (gc[1] * k[2] - gc[2] * k[1], gc[2] * k[0] - gc[0] * k[2],
              gc[0] * k[1] - gc[1] * k[0])
        gtw3 = (gz * p.u, gz * p.v, gz)
        zero = torch.zeros_like(gz)
        on3d = p.on3d
        terms = [
            torch.where(on3d, zero, grho * (4.0 * p.dx)),
            torch.where(on3d, zero, grho * (4.0 * p.dy)),
            *[torch.where(on3d, -gk[j], zero) for j in range(3)],
            *[torch.where(on3d, -gl[j], zero) for j in range(3)],
            *[torch.where(on3d, (px * gk[j] + py * gl[j]) + gtw3[j], zero)
              for j in range(2)],
            torch.where(on3d, (px * gk[2] + py * gl[2]) + gtw3[2], gz),
            p.gexp * dalpha,
            w * g_rgb[:, 0], w * g_rgb[:, 1], w * g_rgb[:, 2],
            w * g_n[:, 0], w * g_n[:, 1], w * g_n[:, 2],
        ]
        terms = torch.stack(terms)                          # (18, T, P)
        sums = torch.where(p.blend, terms, 0.0).sum(dim=2)  # (18, T)
        grad[:, col[live]] = sums[:, live]
        t = torch.where(p.blend, p.t_new, t)
        done = done | p.stops
    return grad
