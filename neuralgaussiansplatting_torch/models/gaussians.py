"""The Gaussian point cloud as capacity-padded tensors with an ``alive`` mask.

Port of ``models/gaussians.py``: the same leaves, shapes and parameter
semantics (log-scale, logit opacity, raw wxyz quaternion, flat
coefficient-major SH, 64-d neural features), so that a state compares tensor
for tensor with the JAX package's. Dead padding slots carry zeros (identity
quaternions) and are rendered with opacity 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from neuralgaussiansplatting_torch import resolve_device
from neuralgaussiansplatting_torch.ops import knn
from neuralgaussiansplatting_torch.ops import transforms
from neuralgaussiansplatting_torch.ops.sh import RGB2SH
from neuralgaussiansplatting_torch.scene import ply as ply_io

NUM_NEURAL_FEATURES = 64


class GaussianParams(NamedTuple):
    """Trainable parameters; every leaf is capacity-padded along dim 0."""

    xyz: torch.Tensor            # (P, 3)
    normals: torch.Tensor        # (P, 3)
    features_dc: torch.Tensor    # (P, 3) SH DC (rgb)
    features_rest: torch.Tensor  # (P, 3*(K-1)) coefficient-major flat
    features: torch.Tensor       # (P, 64) neural features
    scaling: torch.Tensor        # (P, 3) log-scale
    rotation: torch.Tensor       # (P, 4) quaternion wxyz
    opacity: torch.Tensor        # (P, 1) logit


class GaussianState(NamedTuple):
    """Non-trainable per-Gaussian state (alive mask + densification stats)."""

    alive: torch.Tensor               # (P,) bool
    max_radii2d: torch.Tensor         # (P,) float32
    xyz_gradient_accum: torch.Tensor  # (P,) float32
    denom: torch.Tensor               # (P,) float32


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def get_scaling(p: GaussianParams) -> torch.Tensor:
    # e^25 is far above any physical scale; squaring more would overflow f32
    return torch.exp(torch.clamp_max(p.scaling, 25.0))


def get_rotation(p: GaussianParams) -> torch.Tensor:
    return p.rotation / torch.sqrt(torch.clamp_min(
        torch.sum(p.rotation * p.rotation, dim=-1, keepdim=True), 1e-16))


def get_opacity(p: GaussianParams, alive: torch.Tensor | None = None) -> torch.Tensor:
    """(P,) activated opacity; dead slots are forced to 0 so they never
    rasterize."""
    o = torch.reciprocal(1.0 + torch.exp(-p.opacity)).squeeze(-1)
    if alive is not None:
        o = torch.where(alive, o, 0.0)
    return o


def get_features(p: GaussianParams) -> torch.Tensor:
    """(P, 3*K) SH coefficients (dc + rest), coefficient-major flat."""
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def get_covariance(p: GaussianParams, scaling_modifier: float = 1.0) -> torch.Tensor:
    """(P, 6) packed world covariance."""
    cov = transforms.build_covariance_3d(
        get_scaling(p), scaling_modifier, get_rotation(p))
    return transforms.strip_symmetric(cov)


def normalize_params(params: GaussianParams) -> GaussianParams:
    """Flatten rank-3 SH leaves ((P, 1, 3) / (P, K-1, 3), the layout of
    older checkpoints) into the flat coefficient-major (P, 3) /
    (P, 3*(K-1)) storage; a row-major reshape is that flattening."""
    dc, rest = params.features_dc, params.features_rest
    if dc.ndim == 3:
        dc = dc.reshape(dc.shape[0], -1)
    if rest.ndim == 3:
        rest = rest.reshape(rest.shape[0], -1)
    return params._replace(features_dc=dc, features_rest=rest)


def repad(params: GaussianParams, state: GaussianState, capacity: int):
    """(params, state) re-padded to ``capacity`` slots.

    Growing pads with zeros (identity quaternions in the new rotation rows);
    shrinking raises ValueError when an alive slot lies past the new
    capacity.
    """
    cap0 = params.xyz.shape[0]
    if capacity == cap0:
        return params, state
    if capacity < cap0:
        if bool(state.alive[capacity:].any()):
            raise ValueError(
                f"cannot shrink capacity {cap0} -> {capacity}: alive "
                f"Gaussians exist beyond the requested capacity")
        return (GaussianParams(*(a[:capacity] for a in params)),
                type(state)(*(a[:capacity] for a in state)))

    def grow(a):
        return torch.cat([a, a.new_zeros((capacity - cap0,) + a.shape[1:])])

    new_params = GaussianParams(*(grow(a) for a in params))
    rotation = new_params.rotation.clone()
    rotation[cap0:, 0] = 1.0
    return (new_params._replace(rotation=rotation),
            type(state)(*(grow(a) for a in state)))


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def _pad(a: np.ndarray, capacity: int) -> np.ndarray:
    pad = [(0, capacity - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def _pad_rotation(a: np.ndarray, capacity: int) -> np.ndarray:
    """Pad quaternions with identity (w=1): a zero quaternion NaNs through
    normalization."""
    out = np.zeros((capacity, 4), a.dtype)
    out[:, 0] = 1.0
    out[: a.shape[0]] = a
    return out


def _to_model(leaves: dict, n: int, capacity: int, device):
    """Padded numpy leaves -> (GaussianParams, GaussianState) on ``device``."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    params = GaussianParams(**{k: put(v) for k, v in leaves.items()})
    state = GaussianState(
        alive=torch.arange(capacity, device=dev) < n,
        max_radii2d=torch.zeros(capacity, dtype=torch.float32, device=dev),
        xyz_gradient_accum=torch.zeros(capacity, dtype=torch.float32, device=dev),
        denom=torch.zeros(capacity, dtype=torch.float32, device=dev),
    )
    return params, state


def create_from_pcd(points: np.ndarray, colors: np.ndarray,
                    normals: np.ndarray, sh_degree: int,
                    capacity: int | None = None, device="cuda",
                    surfel: bool = False):
    """(GaussianParams, GaussianState) from a point cloud.

    ``capacity`` defaults to the point count; a larger value leaves room for
    densification. ``surfel`` makes 2D Gaussian Splatting's surfels: two
    scales a row and rotations uniform in [0, 1) per component (2DGS's
    ``torch.rand``), drawn from a generator of seed 0.
    """
    n = points.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < point count {n}")
    k = (sh_degree + 1) ** 2

    features_dc = RGB2SH(np.asarray(colors, np.float32))
    features_rest = np.zeros((n, 3 * (k - 1)), np.float32)
    dist2 = np.maximum(knn.mean_sq_dist_3nn(points), 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(2 if surfel else 3,
                                                     axis=1)
    if surfel:
        rots = np.random.default_rng(0).random((n, 4), np.float32)
    else:
        rots = np.zeros((n, 4), np.float32)
        rots[:, 0] = 1.0
    init = np.full((n, 1), 0.1, np.float32)
    opacities = np.log(init / (1.0 - init))          # inverse_sigmoid(0.1)

    leaves = dict(
        xyz=_pad(np.asarray(points, np.float32), capacity),
        normals=_pad(np.asarray(normals, np.float32), capacity),
        features_dc=_pad(features_dc.astype(np.float32), capacity),
        features_rest=_pad(features_rest, capacity),
        features=np.zeros((capacity, NUM_NEURAL_FEATURES), np.float32),
        scaling=_pad(scales.astype(np.float32), capacity),
        rotation=_pad_rotation(rots, capacity),
        opacity=_pad(opacities.astype(np.float32), capacity),
    )
    return _to_model(leaves, n, capacity, device)


def params_from_numpy(params, state, device="cuda"):
    """The JAX package's (GaussianParams, GaussianState), given as numpy
    arrays, as the port's tensors on ``device``, bit for bit.

    ``params``/``state`` are NamedTuples or dicts keyed by the field names;
    any leaf ``np.asarray`` accepts will do.
    """
    dev = resolve_device(device)

    def leaves(obj, names):
        d = obj._asdict() if hasattr(obj, "_asdict") else dict(obj)
        missing = set(names) - set(d)
        if missing:
            raise KeyError(f"missing leaves: {sorted(missing)}")
        return {k: torch.from_numpy(np.array(d[k])).to(dev) for k in names}

    return (GaussianParams(**leaves(params, GaussianParams._fields)),
            GaussianState(**leaves(state, GaussianState._fields)))


def opt_state_from_numpy(groups: dict, device="cuda") -> dict:
    """The JAX package's per-group Adam state as the port's optimizer state.

    ``groups`` maps each optimized ``GaussianParams`` field to its optax
    (mu, nu, count), as numpy arrays (count a scalar); the result is the
    ``train.optim.Adam`` state on ``device``, bit for bit.
    """
    from neuralgaussiansplatting_torch.train.optim import AdamGroup
    dev = resolve_device(device)
    return {name: AdamGroup(torch.from_numpy(np.array(mu)).to(dev),
                            torch.from_numpy(np.array(nu)).to(dev),
                            int(count))
            for name, (mu, nu, count) in groups.items()}


# ---------------------------------------------------------------------------
# PLY serialization (reference schema)
# ---------------------------------------------------------------------------

def ply_attribute_names(params: GaussianParams):
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(params.features_dc.shape[1])]
    names += [f"f_rest_{i}" for i in range(params.features_rest.shape[1])]
    names += [f"features_{i}" for i in range(params.features.shape[1])]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(params.scaling.shape[1])]
    names += [f"rot_{i}" for i in range(params.rotation.shape[1])]
    return names


def save_ply(path: str, params: GaussianParams, alive: torch.Tensor):
    """Write alive Gaussians in the reference layout (f_rest channel-major
    on disk; the flat storage here is coefficient-major)."""
    mask = alive.detach().cpu().numpy()
    p = {k: v.detach().cpu().numpy()[mask] for k, v in params._asdict().items()}
    n = p["xyz"].shape[0]
    f_rest = p["features_rest"].reshape(n, -1, 3).transpose(0, 2, 1)
    cols = np.concatenate([
        p["xyz"], p["normals"],
        p["features_dc"],
        f_rest.reshape(n, -1),
        p["features"], p["opacity"], p["scaling"], p["rotation"],
    ], axis=1)
    ply_io.write_ply(path, ply_attribute_names(params), cols)


def load_ply(path: str, capacity: int | None = None, device="cuda"):
    """Read a reference-schema checkpoint into padded params on ``device``.

    Returns (params, state, sh_degree). Files without the fork's
    ``features_*`` or normals (plain upstream 3DGS) load with zeros there.
    """
    resolve_device(device)
    v = ply_io.read_ply(path)
    names = set(v.dtype.names)
    n = len(v)
    capacity = capacity or n

    def grab(prefix, count):
        return np.stack([v[f"{prefix}_{i}"] for i in range(count)], axis=1)

    def count(prefix):
        return len([x for x in names if x.startswith(prefix)])

    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "nx" in names:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(xyz)
    f_dc = grab("f_dc", 3)
    n_rest = count("f_rest_")
    if n_rest:
        # channel-major on disk -> coefficient-major flat
        f_rest = grab("f_rest", n_rest).reshape(
            n, 3, n_rest // 3).transpose(0, 2, 1).reshape(n, -1)
    else:
        f_rest = np.zeros((n, 0), np.float32)
    n_feat = count("features_")
    feats = grab("features", n_feat) if n_feat else np.zeros(
        (n, NUM_NEURAL_FEATURES), np.float32)
    opacity = v["opacity"].reshape(n, 1)

    leaves = dict(
        xyz=_pad(xyz, capacity),
        normals=_pad(normals, capacity),
        features_dc=_pad(f_dc.astype(np.float32), capacity),
        features_rest=_pad(f_rest.astype(np.float32), capacity),
        features=_pad(feats.astype(np.float32), capacity),
        scaling=_pad(grab("scale", count("scale_")).astype(np.float32), capacity),
        rotation=_pad_rotation(grab("rot", count("rot_")).astype(np.float32),
                               capacity),
        opacity=_pad(opacity.astype(np.float32), capacity),
    )
    params, state = _to_model(leaves, n, capacity, device)
    sh_degree = int(round((n_rest // 3 + 1) ** 0.5)) - 1
    return params, state, sh_degree


class GaussianModel:
    """Host-side holder of the (params, state) tensors, the SH warm-up
    counter (``active_sh_degree`` rises by one per ``oneup_sh_degree`` up to
    ``max_sh_degree``) and the scene extent densification uses. ``surfel``
    makes ``create_from_pcd`` build 2D Gaussian Splatting's surfels (two
    scales a row); a model read from a file is what the file holds."""

    def __init__(self, sh_degree: int = 3, device="cuda",
                 surfel: bool = False):
        self.surfel = surfel
        self.max_sh_degree = sh_degree
        self.active_sh_degree = 0
        self.params: GaussianParams | None = None
        self.state: GaussianState | None = None
        self.spatial_lr_scale = 1.0
        self.device = resolve_device(device)

    @property
    def num_alive(self) -> int:
        return int(self.state.alive.sum())

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    def oneup_sh_degree(self):
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1

    def create_from_pcd(self, pcd, spatial_lr_scale: float,
                        capacity: int | None = None):
        """``pcd`` has ``points``, ``colors`` and ``normals`` (N, 3)."""
        self.spatial_lr_scale = float(spatial_lr_scale)
        self.params, self.state = create_from_pcd(
            pcd.points, pcd.colors, pcd.normals, self.max_sh_degree,
            capacity, device=self.device, surfel=self.surfel)

    def capture(self) -> dict:
        """The model as a dict of ints, floats and host tensors (what
        ``torch.save`` with ``weights_only`` loading takes); the optimizer
        state belongs to the ``Trainer``, which checkpoints it."""
        def host(nt):
            return {k: v.detach().cpu() for k, v in nt._asdict().items()}

        return {
            "active_sh_degree": self.active_sh_degree,
            "max_sh_degree": self.max_sh_degree,
            "spatial_lr_scale": self.spatial_lr_scale,
            "params": host(self.params),
            "state": host(self.state),
        }

    def restore(self, payload: dict):
        """Inverse of ``capture``; ``params``/``state`` may also be
        sequences in field order (the JAX package's NamedTuples as numpy),
        and rank-3 SH leaves are flattened."""
        def put(v):
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v))
            return v.to(self.device)

        def leaves(obj, cls):
            if isinstance(obj, dict):
                obj = [obj[k] for k in cls._fields]
            return cls(*(put(v) for v in obj))

        self.active_sh_degree = int(payload["active_sh_degree"])
        self.max_sh_degree = int(payload["max_sh_degree"])
        self.spatial_lr_scale = float(payload["spatial_lr_scale"])
        self.params = normalize_params(leaves(payload["params"],
                                              GaussianParams))
        self.state = leaves(payload["state"], GaussianState)

    def save_ply(self, path: str):
        save_ply(path, self.params, self.state.alive)

    def load_ply(self, path: str, capacity: int | None = None):
        self.params, self.state, deg = load_ply(path, capacity, self.device)
        self.active_sh_degree = self.max_sh_degree = max(deg, 0)
