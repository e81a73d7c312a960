"""Scaffold-GS's anchor model (Lu et al., "Scaffold-GS: Structured 3D
Gaussians for View-Adaptive Rendering", CVPR 2024; github.com/city-super/
Scaffold-GS), with that repository's default switches: feature bank off,
no distance inputs.

An anchor ``v`` stores a position ``x_v`` (3, trained at rate 0), a feature
``f_v`` (``FEAT_DIM``), ``N_OFFSETS`` offsets ``O_v`` (3 each) and a
log-scaling ``s_v`` (6), ``l_v = exp(s_v)``. Three MLPs shared by every
anchor, each ``Linear(in, HIDDEN) -> ReLU -> Linear(HIDDEN, out)``, and an
appearance embedding of ``APPEARANCE_DIM`` per training camera decode each
anchor seen from camera centre ``c`` into ``N_OFFSETS`` neural Gaussians:
with ``d = (x_v - c) / |x_v - c|``, neural Gaussian ``k`` has

- position ``x_v + O_v[k] * l_v[:3]``,
- scale ``l_v[3:] * sigmoid(cov[k, :3])``, rotation ``normalize(cov[k,
  3:7])`` (``cov`` = the covariance MLP of ``[f_v, d]``, 7 a Gaussian),
- opacity ``tanh(opacity MLP of [f_v, d])[k]``, kept only where > 0,
- colour ``sigmoid(colour MLP of [f_v, d, emb(camera)])[k]``, handed to the
  rasterizer as a precomputed colour.

Only anchors that pass the visibility prefilter are decoded: an anchor
passes where the preprocess gives it a radius > 0 as a Gaussian of scales
``l_v[:3]``, identity rotation and opacity 1 (``visible_anchors``).

The original compacts the visible anchors and the kept Gaussians with
boolean indexing, a read of the device's counts every step. Here nothing
is read: ``compact`` gathers the visible anchors on the device into a
fixed number of rows (sized from probe renders), and the gate is dead
slots: every candidate keeps its row, and one that is not kept (its
anchor not visible, or its opacity not above 0) gets opacity 0, which the
preprocess culls (radius 0), so it is never binned and takes no gradient.
(Decoding every anchor, the invisible ones as dead slots too, was 8 %
slower on garden's cameras, where ~60 % of the anchors are visible.)

The anchors' rotation (identity) and opacity are stored but never trained
by the original: the prefilter that reads them has no gradient. They are
left out.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from neuralgaussiansplatting_torch.ops import knn
from neuralgaussiansplatting_torch.ops import preprocess as pp

FEAT_DIM = 32
N_OFFSETS = 10
HIDDEN = 32
APPEARANCE_DIM = 32
COV_DIM = 7          # 3 scale factors and a quaternion per neural Gaussian
SCALE_REG = 0.01     # the loss's weight of the kept Gaussians' mean volume


class ScaffoldParams(NamedTuple):
    """The anchors' trainable leaves."""

    anchor: torch.Tensor       # (N, 3) positions
    offset: torch.Tensor       # (N, N_OFFSETS, 3)
    anchor_feat: torch.Tensor  # (N, FEAT_DIM)
    scaling: torch.Tensor      # (N, 6) log of l_v


class Generated(NamedTuple):
    """The neural Gaussians of one view, ``N_OFFSETS`` rows an anchor in
    anchor order (a candidate's row is anchor * N_OFFSETS + k)."""

    xyz: torch.Tensor          # (M, 3)
    scaling: torch.Tensor      # (M, 3) activated
    rotation: torch.Tensor     # (M, 4) unit quaternions
    color: torch.Tensor        # (M, 3) in (0, 1)
    opacity: torch.Tensor      # (M,) tanh where kept, else 0
    gate: torch.Tensor         # (M,) bool: anchor visible and tanh > 0


def mlp_shapes(num_cameras: int) -> dict:
    """{leaf: shape} of the MLPs and the embedding, under the original's
    ``state_dict`` names (``nn.Sequential`` layers 0 and 2)."""
    view_in = FEAT_DIM + 3
    out = {}
    for name, cin, cout in (("mlp_opacity", view_in, N_OFFSETS),
                            ("mlp_cov", view_in, COV_DIM * N_OFFSETS),
                            ("mlp_color", view_in + APPEARANCE_DIM,
                             3 * N_OFFSETS)):
        out |= {f"{name}.0.weight": (HIDDEN, cin), f"{name}.0.bias": (HIDDEN,),
                f"{name}.2.weight": (cout, HIDDEN), f"{name}.2.bias": (cout,)}
    out["embedding_appearance.weight"] = (num_cameras, APPEARANCE_DIM)
    return out


def init_nets(num_cameras: int, seed: int | torch.Generator = 0,
              device="cuda") -> dict:
    """{leaf: tensor} of the MLPs and the embedding as PyTorch's modules
    initialise them (``nn.Linear``: weight and bias uniform in +-1 /
    sqrt(fan_in); ``nn.Embedding``: standard normal), drawn on the CPU from
    ``seed`` (an int or a CPU generator) in ``mlp_shapes``' order, so one
    seed gives the same nets on every device."""
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator().manual_seed(int(seed)))
    shapes = mlp_shapes(num_cameras)
    out = {}
    for name, shape in shapes.items():
        if name.startswith("embedding"):
            x = torch.randn(shape, generator=gen)
        else:
            fan_in = shapes[name.replace(".bias", ".weight")][1]
            bound = 1.0 / math.sqrt(fan_in)
            x = (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound
        out[name] = x.to(device)
    return out


def voxelize(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """The anchor positions of a point cloud: its points snapped to a grid
    of ``voxel_size``, one anchor a voxel (the original's
    ``np.unique(np.round(points / voxel_size), axis=0) * voxel_size``)."""
    pts = np.asarray(points, np.float64)
    return (np.unique(np.round(pts / voxel_size), axis=0)
            * voxel_size).astype(np.float32)


def init_anchors(points: np.ndarray, voxel_size: float = 0.001,
                 device="cuda") -> ScaffoldParams:
    """Anchors on the voxels of ``points`` as the original initialises them:
    zero offsets and features, each of the six log-scalings the log of the
    root mean squared distance to the 3 nearest anchors (at least 1e-7
    squared)."""
    anchors = voxelize(points, voxel_size)
    n = anchors.shape[0]
    dist2 = np.maximum(knn.mean_sq_dist_3nn(anchors), 1e-7)
    scaling = np.repeat(np.log(np.sqrt(dist2))[:, None], 6, axis=1)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return ScaffoldParams(anchor=put(anchors),
                          offset=put(np.zeros((n, N_OFFSETS, 3))),
                          anchor_feat=put(np.zeros((n, FEAT_DIM))),
                          scaling=put(scaling))


def visible_anchors(cam, params: ScaffoldParams, block_x: int,
                    block_y: int) -> torch.Tensor:
    """(N,) bool, no gradient: the anchors to which the preprocess gives a
    radius > 0 as Gaussians of scales ``l_v[:3]``, identity rotation and
    opacity 1 (square rects: in front of the 0.2 near plane, a non-zero
    determinant, a rect on the ``block_x`` x ``block_y`` tile grid). On the
    card one launch of the preprocess kernel, its colour variant."""
    with torch.no_grad():
        anchor = params.anchor.detach()
        n = anchor.shape[0]
        scales = torch.exp(params.scaling.detach()[:, :3])
        rot = anchor.new_zeros((1, 4))
        rot[:, 0] = 1.0
        pre = pp.preprocess_gaussians(
            anchor, scales, rot.expand(n, 4), anchor.new_ones(n), None, 0,
            cam, block_x, block_y,
            colors_precomp=anchor.new_zeros(()).expand(n, 3))
        return pre.radii > 0


def compact(mask: torch.Tensor, capacity: int) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """(indices, count): the first ``capacity`` rows of ``mask``'s stable
    partition (the rows it marks, in order, then the others, in order), on
    the device and without reading it; ``count`` () is the marked rows, so
    ``count > capacity`` says that some were left out. The indices are
    distinct, so a gather by them has a backward without colliding adds."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    return order[:min(capacity, mask.shape[0])], mask.sum()


def _mlp(x: torch.Tensor, nets: dict, name: str) -> torch.Tensor:
    h = F.relu(F.linear(x, nets[f"{name}.0.weight"], nets[f"{name}.0.bias"]))
    return F.linear(h, nets[f"{name}.2.weight"], nets[f"{name}.2.bias"])


def generate(campos: torch.Tensor, view: int, params: ScaffoldParams,
             nets: dict, visible: torch.Tensor) -> Generated:
    """The neural Gaussians of every row of ``params`` seen from camera
    centre ``campos`` (3,), the appearance embedding's row ``view``;
    ``visible`` (N,) bool gates them (a candidate of a row that is not
    visible is not kept). Differentiable in ``params`` and ``nets``."""
    n = params.anchor.shape[0]
    k = N_OFFSETS
    ob = params.anchor - campos
    d = ob / ob.norm(dim=1, keepdim=True)
    local = torch.cat([params.anchor_feat, d], 1)
    app = nets["embedding_appearance.weight"][view].expand(n, APPEARANCE_DIM)
    neural_opacity = torch.tanh(_mlp(local, nets, "mlp_opacity")).reshape(-1)
    color = torch.sigmoid(_mlp(torch.cat([local, app], 1), nets,
                               "mlp_color")).reshape(n * k, 3)
    cov = _mlp(local, nets, "mlp_cov").reshape(n, k, COV_DIM)
    grid = torch.exp(params.scaling)
    scaling = (grid[:, None, 3:] * torch.sigmoid(cov[..., :3])).reshape(-1, 3)
    rotation = F.normalize(cov[..., 3:].reshape(-1, 4), dim=-1)
    xyz = (params.anchor[:, None] + params.offset * grid[:, None, :3]
           ).reshape(-1, 3)
    gate = (visible[:, None].expand(n, k).reshape(-1)
            & (neural_opacity > 0.0))
    opacity = torch.where(gate, neural_opacity, 0.0)
    return Generated(xyz, scaling, rotation, color, opacity, gate)


def scale_regulariser(g: Generated) -> torch.Tensor:
    """The mean over the kept Gaussians of their scales' product (0 where
    none is kept), as a device scalar: nothing is read back (the product is
    written out: ``prod``'s backward reads its zeros back to the host)."""
    s = g.scaling
    volume = torch.where(g.gate, s[:, 0] * s[:, 1] * s[:, 2], 0.0)
    return volume.sum() / g.gate.sum().clamp_min(1)
