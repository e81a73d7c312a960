"""The program under test, ``neuralgaussiansplatting_torch``, as the loops
(``loops/<loop>.py``) drive it, and what they share: the port's modules
imported when a run starts, its kernel launch counters, the sizing of its
instance buffers from probe renders (``size_from_probe``), the camera
order drawn from the seed, and what a measured window did.

From the program the benchmark takes only the system under test, its
kernel launch counters and its kernel names.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ngsbench import scene

# a copy of the port's garden-bench sizing rule (tools/bench_garden.py)
PROBE_CAPACITY = 1 << 24
PROBE_MAX_PER_TILE = 1 << 20    # no cap: the aligned demand of every tile
MAX_PER_TILE = 4096
# the blend kernels as the profiler names them (a record's name holds it),
# by the label the launch counters and the per-layer readers use
KERNEL_NAMES = {"K1": "blend_seq_fwd_kernel", "K2": "blend_seq_bwd_kernel"}


def size_from_probe(num_rendered: int, aligned_demand: int):
    """(capacity, packed capacity) from a probe's demand: the power of two
    above 1.15 x the instances, and 1.05 x the aligned demand rounded up to
    the next multiple of 2^17."""
    cap = 1 << max(int(num_rendered * 1.15).bit_length(), 1)
    kcap = ((int(aligned_demand * 1.05) // (1 << 17)) + 1) * (1 << 17)
    return cap, kcap


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def background(cfg: dict, device) -> torch.Tensor:
    return torch.tensor([1.0, 1.0, 1.0] if cfg["white_background"]
                        else [0.0, 0.0, 0.0], device=device)


class Program:
    """The port's modules, imported when a run starts."""

    def __init__(self):
        from neuralgaussiansplatting_torch import gaussian_renderer
        from neuralgaussiansplatting_torch.models import gaussians
        from neuralgaussiansplatting_torch.ops import blend_seq, rasterize
        from neuralgaussiansplatting_torch.ops.preprocess import CameraParams
        from neuralgaussiansplatting_torch.train import loop, optim
        self.renderer = gaussian_renderer
        self.gm = gaussians
        self.blend_seq = blend_seq
        self.rast = rasterize
        self.CameraParams = CameraParams
        self.loop = loop
        self.optim = optim

    def launches(self) -> dict:
        """The launch counters of ``KERNEL_NAMES``' kernels."""
        return {"K1": self.blend_seq.launches, "K2": self.blend_seq.bwd_launches}

    def camera(self, cam: scene.Camera, device):
        return self.CameraParams(cam.view, cam.full_proj, cam.campos,
                                 cam.tan_fovx, cam.tan_fovy, cam.width,
                                 cam.height, device=device)

    def model(self, cfg: dict, cloud: dict, extent: float):
        """A ``GaussianModel`` holding ``cloud`` (all slots alive, SH at
        its full degree, normals and neural features zero)."""
        n = cloud["xyz"].shape[0]
        dev = cloud["xyz"].device
        params = self.gm.GaussianParams(
            xyz=cloud["xyz"], normals=torch.zeros((n, 3), device=dev),
            features_dc=cloud["features_dc"],
            features_rest=cloud["features_rest"],
            features=torch.zeros((n, self.gm.NUM_NEURAL_FEATURES),
                                 device=dev),
            scaling=cloud["scaling"], rotation=cloud["rotation"],
            opacity=cloud["opacity"])
        zeros = torch.zeros(n, device=dev)
        state = self.gm.GaussianState(
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            max_radii2d=zeros, xyz_gradient_accum=zeros.clone(),
            denom=zeros.clone())
        model = self.gm.GaussianModel(cfg["sh_degree"], device=dev)
        model.params, model.state = params, state
        model.active_sh_degree = cfg["sh_degree"]
        model.spatial_lr_scale = extent
        return model

    def settings(self, cfg: dict, **kw):
        """The train entry's pipeline defaults (``config.PipelineParams``)
        with ``kw``."""
        p = cfg["pipeline"]
        return self.rast.make_settings(
            p["backend"], tight_culling=p["tight_culling"],
            precise_cull=p["precise_cull"], expand=p["expand"],
            fast_sort=p["fast_sort"], **kw)

    def sized_settings(self, cfg: dict, model, cams, bg, log):
        """Settings whose buffers fit every view of ``cams``: one probe
        render of each, then ``size_from_probe`` on the largest demand;
        ``max_per_tile`` the pipeline's 4096, doubled until it holds the
        densest tile (8192 in the garden bench)."""
        def probe(views, capacity):
            settings = self.settings(cfg, capacity=capacity,
                                     max_per_tile=PROBE_MAX_PER_TILE)
            demand = torch.zeros(3, dtype=torch.int64, device=bg.device)
            with torch.no_grad():
                for cam in views:
                    out = self.renderer.render(
                        cam, model.params, model.state.alive,
                        model.active_sh_degree, bg, settings)
                    got = torch.stack([out["num_rendered"].long(),
                                       out["aligned_demand"].long(),
                                       out["max_per_tile"].long()])
                    demand = torch.maximum(demand, got)
            return [int(v) for v in demand.tolist()]

        # the monitors read true demand only while every instance fits the
        # probe's buffer: the first view sets the others' buffer, and all
        # are probed again at the largest one where a view overflows it
        first = probe(cams[:1], PROBE_CAPACITY)[0]
        capacity = size_from_probe(first, 0)[0]
        rendered, aligned, tile_max = probe(cams, capacity)
        if rendered > capacity:
            rendered, aligned, tile_max = probe(cams, PROBE_CAPACITY)
        cap, kcap = size_from_probe(rendered, aligned)
        per_tile = MAX_PER_TILE
        while per_tile < tile_max:
            per_tile *= 2
        log(f"probe: {len(cams)} views, instances {rendered}, aligned "
            f"{aligned}, densest tile {tile_max} -> capacity {cap}, packed "
            f"{kcap}, max_per_tile {per_tile}")
        return self.settings(cfg, capacity=cap, packed_capacity=kcap,
                             max_per_tile=per_tile)


def camera_stream(seed: int, views: int):
    """Camera indices without end: seeded permutations of the views."""
    rng = np.random.default_rng(int(seed))
    while True:
        yield from (int(i) for i in rng.permutation(views))


@dataclasses.dataclass
class Window:
    """What a measured window did."""

    ops: int
    seconds: float
    latencies: list
    failed: int
