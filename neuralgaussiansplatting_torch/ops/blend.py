"""Front-to-back alpha blending over tile-binned instances (plain scan).

Port of ``ops/blend.py``: the rasterizer's ``backend="xla"`` oracle, plain
PyTorch on any device and differentiable by autograd. Every tile is blended
at once as dense (T, CHUNK, PIX) math in a loop over depth chunks; the
front-to-back product is a cumulative product along the chunk axis. An
instance contributes iff the running transmittance after it stays >= 1e-4
and no earlier instance already stopped the pixel; the crossing instance is
not blended and T keeps its last value >= 1e-4.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neuralgaussiansplatting_torch.ops.binning import Instances

STOP_T = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99


class BlendResult(NamedTuple):
    color: torch.Tensor      # (T, PIX, 3) pre-background composited color
    final_t: torch.Tensor    # (T, PIX) final transmittance
    n_contrib: torch.Tensor  # (T, PIX) int32 1-based index of last blend


def tile_pixel_coords(tiles_x: int, tiles_y: int, block_x: int, block_y: int,
                      device):
    """(T, PIX) pixel x/y coordinates (integer pixel positions) per tile."""
    t = torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=device)
    tx = (t % tiles_x)[:, None]
    ty = (t // tiles_x)[:, None]
    j = torch.arange(block_x * block_y, dtype=torch.int32, device=device)[None, :]
    px = (tx * block_x + j % block_x).float()
    py = (ty * block_y + j // block_x).float()
    return px, py


def compute_alpha(xy, con, op, px, py):
    """Masked alpha of instances against pixels.

    xy: (..., 2), con: (..., 3), op: (...,) broadcast against px/py
    (..., PIX). Applies the power > 0 / alpha < 1/255 cutoffs and the 0.99
    clamp.
    """
    dx = xy[..., 0:1] - px
    dy = xy[..., 1:2] - py
    a, b, c = con[..., 0:1], con[..., 1:2], con[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(op[..., None] * torch.exp(power), ALPHA_MAX)
    return torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, 0.0)


def blend_tiles(
    inst: Instances,
    means2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    rgb: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    block_x: int,
    block_y: int,
    max_per_tile: int,
    chunk: int = 32,
) -> BlendResult:
    """Blend all tiles front-to-back over at most ``max_per_tile`` instances."""
    dev = means2d.device
    num_tiles = tiles_x * tiles_y
    pix = block_x * block_y
    n = means2d.shape[0]
    capacity = inst.gid.shape[0]
    n_chunks = (max_per_tile + chunk - 1) // chunk

    px, py = tile_pixel_coords(tiles_x, tiles_y, block_x, block_y, dev)
    px, py = px[:, None, :], py[:, None, :]
    lanes = torch.arange(chunk, device=dev)[None, :]
    t_in = torch.ones((num_tiles, pix), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, pix), dtype=torch.bool, device=dev)
    color = torch.zeros((num_tiles, pix, 3), dtype=torch.float32, device=dev)
    last = torch.zeros((num_tiles, pix), dtype=torch.int64, device=dev)
    for c in range(n_chunks):
        local = c * chunk + lanes                                   # (1, CH)
        in_tile = local < inst.tile_count[:, None]                  # (T, CH)
        pos = torch.clamp(inst.tile_start[:, None] + local, 0, capacity - 1)
        g = torch.clamp(inst.gid[pos].long(), 0, n - 1)             # (T, CH)

        alpha = compute_alpha(means2d[g], conic[g], opacity[g], px, py)
        alpha = torch.where(in_tile[..., None], alpha, 0.0)         # (T, CH, P)

        cum = t_in[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)  # inclusive
        cum_excl = torch.cat([t_in[:, None, :], cum[:, :-1, :]], dim=1)
        alive = (cum >= STOP_T) & ~done[:, None, :]
        contrib = torch.where(alive, alpha * cum_excl, 0.0)
        color = color + torch.einsum("tcp,tck->tpk", contrib, rgb[g])
        t_in = torch.where(alive, cum, t_in[:, None, :]).amin(dim=1)
        done = done | (cum < STOP_T).any(dim=1)
        blended = alive & (alpha > 0.0)
        last = torch.maximum(
            last, torch.where(blended, local[..., None] + 1, 0).amax(dim=1))
    return BlendResult(color=color, final_t=t_in,
                       n_contrib=last.to(torch.int32))


def assemble_image(per_tile: torch.Tensor, tiles_x: int, tiles_y: int,
                   block_x: int, block_y: int, width: int, height: int) -> torch.Tensor:
    """(T, PIX, C) or (T, PIX) tile-major pixels -> (H, W[, C]) image crop."""
    squeeze = per_tile.ndim == 2
    if squeeze:
        per_tile = per_tile[..., None]
    c = per_tile.shape[-1]
    img = per_tile.reshape(tiles_y, tiles_x, block_y, block_x, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(
        tiles_y * block_y, tiles_x * block_x, c)
    img = img[:height, :width]
    return img[..., 0] if squeeze else img
