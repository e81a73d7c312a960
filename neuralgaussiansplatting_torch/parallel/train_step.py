"""Data-parallel training: a camera batch per optimizer step, split over
the ranks of the mesh's data axis, the Gaussians replicated on every rank.

Port of ``parallel/train_step.py``. Semantics are the JAX package's: a
batch of B cameras per optimizer step is the batched analogue of B
reference iterations. The loss is the mean over the B cameras, and the
densification statistics accumulate each camera's screen-space gradient
norm (rescaled by B, so the densify threshold keeps its meaning) and
visibility count, summed over the batch.

The JAX package vmaps the render over the batch and lets XLA insert the
gradient sum. Here each rank renders its B / n_data cameras, sums their
photometric losses, divides by the global B and runs one backward; the
gradients and the statistics' sums then travel in one flat float32 buffer
in a fixed order through one ``all_reduce`` (SUM), the maxima (screen
radii, the capacity monitors) through a second (MAX). Every rank receives
the same sums, takes the same Adam step and the same host decisions
(densify, growth, tuning, with split noise from a generator seeded the
same on every rank), so the replicas stay equal without a broadcast.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.ops.preprocess import CameraParams
from neuralgaussiansplatting_torch.parallel import mesh as mesh_lib
from neuralgaussiansplatting_torch.train import loop
from neuralgaussiansplatting_torch.train import optim
from neuralgaussiansplatting_torch.train.loop import TRAINABLE, TrainState
from neuralgaussiansplatting_torch.utils import losses

MONITORS = ("num_rendered", "max_per_tile", "aligned_demand", "dropped",
            "culled")


def stack_cameras(cams) -> CameraParams:
    """Stack cameras of equal intrinsics into one batch (leading axis =
    camera) on the first one's device; ``CameraParams.camera(i)`` takes
    one back out."""
    first = cams[0]
    key = (first.tan_fovx, first.tan_fovy, first.width, first.height)
    for c in cams[1:]:
        other = (c.tan_fovx, c.tan_fovy, c.width, c.height)
        if other != key:
            raise ValueError(
                "stack_cameras requires identical static intrinsics "
                f"(tan_fov/size); got {other} vs {key} — batch only cameras "
                "that share them (or use steps_per_call=1 / per-resolution "
                "groups)")
    dev = first.view.device
    return CameraParams(
        view=torch.stack([c.view for c in cams]),
        full_proj=torch.stack([c.full_proj for c in cams]),
        campos=torch.stack([c.campos for c in cams]),
        tan_fovx=first.tan_fovx, tan_fovy=first.tan_fovy,
        width=first.width, height=first.height,
        limit_x=first.limit_x, limit_y=first.limit_y, device=dev)


def _reduce(mesh: mesh_lib.Mesh, tensor: torch.Tensor, op) -> torch.Tensor:
    """``tensor`` reduced in place over the data axis (no-op without one)."""
    if mesh.data_group is not None:
        dist.all_reduce(tensor, op=op, group=mesh.data_group)
    return tensor


def make_dp_train_step(mesh: mesh_lib.Mesh, tx: optim.Adam, *,
                       sh_degree: int, settings: rast.RasterizeSettings,
                       lambda_dssim: float = 0.2):
    """The data-parallel step: (TrainState, this rank's cameras stacked,
    their (b, 3, H, W) ground truth, background) -> (TrainState, metrics).
    The global batch is b x ``mesh.n_data``; the metrics (tensors on the
    device) are the batch's: mean loss and PSNR, the maxima of the
    capacity monitors and of the radii."""

    def step(ts: TrainState, cams: CameraParams, gts: torch.Tensor,
             bg: torch.Tensor):
        params = ts.params
        n = params.xyz.shape[0]
        b = gts.shape[0]
        batch = b * mesh.n_data
        alive = ts.gstate.alive
        leaves = {f: getattr(params, f).detach().requires_grad_()
                  for f in TRAINABLE}
        diff_params = params._replace(**leaves)
        offsets = params.xyz.new_zeros((b, n, 2), requires_grad=True)

        loss_sum, psnr_sum, radii, monitors = 0.0, 0.0, [], []
        for i in range(b):
            out = render(cams.camera(i), diff_params, alive, sh_degree, bg,
                         settings, means2d_offset=offsets[i])
            loss_sum = loss_sum + losses.photometric_loss(
                out["render"], gts[i], lambda_dssim)
            psnr_sum = psnr_sum + losses.psnr(
                torch.clamp(out["render"].detach(), 0, 1), gts[i])
            radii.append(out["radii"])
            monitors.append(torch.stack([out[k].long() for k in MONITORS]))
        inputs = list(leaves.values()) + [offsets]
        grads = torch.autograd.grad(loss_sum / batch, inputs,
                                    allow_unused=True)
        goff = grads[-1]
        if goff is None:
            goff = torch.zeros_like(offsets)
        # a leaf the render does not read (``features``) has no gradient on
        # any rank: nothing to reduce, and Adam reads zeros
        grads = {f: g for f, g in zip(leaves, grads[:-1]) if g is not None}

        # the per-camera statistics, summed over this rank's cameras
        radii = torch.stack(radii)                       # (b, N)
        visible = radii > 0
        gnorm = torch.linalg.vector_norm(goff[..., :2], dim=-1) * batch
        sums = torch.cat(
            [g.reshape(-1) for g in grads.values()]
            + [torch.where(visible, gnorm, 0.0).sum(dim=0),
               visible.sum(dim=0).float(),
               torch.stack([loss_sum.detach(), psnr_sum])])
        maxima = torch.cat([torch.where(visible, radii, 0).amax(dim=0).long(),
                            torch.stack(monitors).amax(dim=0),
                            radii.amax().long()[None]])
        _reduce(mesh, sums, dist.ReduceOp.SUM)
        _reduce(mesh, maxima, dist.ReduceOp.MAX)

        parts = list(torch.split(sums, [g.numel() for g in grads.values()]
                                 + [n, n, 2]))
        loss, psnr = parts.pop() / batch
        denom, accum = parts.pop(), parts.pop()
        grads = {f: p.view_as(g) for (f, g), p in zip(grads.items(), parts)}
        grads = params._replace(**{f: grads.get(f) for f in leaves})
        new_params, opt_state = tx.update(grads, ts.opt_state, params,
                                          alive=alive)
        gstate = ts.gstate._replace(
            max_radii2d=torch.maximum(ts.gstate.max_radii2d,
                                      maxima[:n].float()),
            xyz_gradient_accum=ts.gstate.xyz_gradient_accum + accum,
            denom=ts.gstate.denom + denom)
        top = maxima[n:]
        metrics = {"loss": loss, "psnr": psnr,
                   **{k: top[j] for j, k in enumerate(MONITORS)},
                   "radii_max": top[-1]}
        return TrainState(new_params, gstate, opt_state, ts.step + 1), metrics

    return step


def shard_batch(mesh: mesh_lib.Mesh, cams: CameraParams, gts):
    """This rank's part of a stacked global camera batch and of its ground
    truth ((B, 3, H, W), or a sequence of B (3, H, W) tensors, of which
    only this rank's are stacked)."""
    part = mesh_lib.batch_sharded(mesh, cams.view.shape[0])
    local = CameraParams(
        view=cams.view[part], full_proj=cams.full_proj[part],
        campos=cams.campos[part], tan_fovx=cams.tan_fovx,
        tan_fovy=cams.tan_fovy, width=cams.width, height=cams.height,
        limit_x=cams.limit_x, limit_y=cams.limit_y, device=mesh.device)
    gts = gts[part] if isinstance(gts, torch.Tensor) else torch.stack(
        list(gts[part]))
    return local, gts.to(mesh.device)


def replicate_state(mesh: mesh_lib.Mesh, ts: TrainState) -> TrainState:
    """``ts`` with every tensor made equal to rank 0's (in place)."""
    mesh_lib.replicated(mesh, list(ts.params) + list(ts.gstate)
                        + [t for g in ts.opt_state.values()
                           for t in (g.mu, g.nu)])
    return ts


class DPTrainer:
    """Data-parallel trainer with the reference's schedule (densify,
    opacity reset, SH warm-up, capacity growth and tuning) on replicated
    state.

    Each optimizer step consumes a batch of B cameras (split over the data
    axis) and advances the camera counter by B; the schedule fires when the
    counter crosses its iterations, so its cadence matches B sequential
    reference iterations. Host decisions read only values every rank holds
    equal (the reduced metrics, the replicated alive mask)."""

    def __init__(self, gaussians, mesh, opt=None, settings=None,
                 batch_size=None, white_background=False, cameras_extent=1.0,
                 seed=0, auto_grow=True, auto_tune_capacity=True,
                 tune_interval=500):
        self.gaussians = gaussians
        self.mesh = mesh
        self.opt = opt or optim.OptimizationParams()
        self.settings = settings or rast.RasterizeSettings()
        self.batch_size = batch_size or mesh.n_data
        self.white_background = white_background
        self.cameras_extent = cameras_extent
        self.auto_grow = auto_grow
        self.auto_tune_capacity = auto_tune_capacity
        self.tune_interval = tune_interval

        params = gaussians.params
        self.tx = optim.make_optimizer(self.opt, gaussians.spatial_lr_scale)
        self.ts = replicate_state(mesh, TrainState(
            params=params, gstate=gaussians.state,
            opt_state=self.tx.init(params), step=0))
        dev = params.xyz.device
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.bg = torch.tensor([1.0, 1.0, 1.0] if white_background
                               else [0.0, 0.0, 0.0], device=dev)
        self._camera_iter = 0   # cameras consumed so far (reference iters)

    def step(self, cams, gts):
        """One optimizer step over the global batch: a list of B cameras
        (or a stacked one) and their ground truth ((B, 3, H, W) or a list
        of B images; each rank stacks only its own). Returns the metrics."""
        b = len(cams) if isinstance(cams, (list, tuple)) else \
            cams.view.shape[0]
        it0 = self._camera_iter
        self._camera_iter += b
        it1 = self._camera_iter

        def crossed(interval, after=0):
            """Did (it0, it1] cross a multiple m of ``interval`` with
            m > after? The reference's ``iteration > after and iteration %
            interval == 0``, over the step's camera range."""
            m = (it1 // interval) * interval
            return m > it0 and m > after

        if crossed(1000):
            self.gaussians.oneup_sh_degree()

        batch = stack_cameras(cams) if isinstance(cams, (list, tuple)) \
            else cams
        local_cams, local_gts = shard_batch(self.mesh, batch, gts)
        self.ts, metrics = make_dp_train_step(
            self.mesh, self.tx, sh_degree=self.gaussians.active_sh_degree,
            settings=self.settings, lambda_dssim=self.opt.lambda_dssim)(
                self.ts, local_cams, local_gts, self.bg)

        opt = self.opt
        if it1 <= opt.densify_until_iter:
            if crossed(opt.densification_interval,
                       after=opt.densify_from_iter):
                use_size = it1 > opt.opacity_reset_interval
                self.ts, report = loop.densify_step(
                    self.ts, self.generator, self.cameras_extent, cfg=opt,
                    use_size_prune=use_size)
                metrics["densify"] = report
            if crossed(opt.opacity_reset_interval) or (
                    self.white_background
                    and it0 < opt.densify_from_iter <= it1):
                self.ts = loop.reset_opacity_step(self.ts)
            if self.auto_grow and "densify" in metrics:
                if self.maybe_grow():
                    metrics["grew_capacity"] = self.ts.params.xyz.shape[0]

        if self.auto_tune_capacity and crossed(self.tune_interval):
            new_settings, tuned = loop.tune_capacity(
                self.settings, int(metrics["num_rendered"]),
                int(metrics["aligned_demand"]))
            if tuned:
                self.settings = new_settings
                metrics["retuned_capacity"] = new_settings.capacity
        return metrics

    def maybe_grow(self, headroom: float = 0.85, factor: int = 2) -> bool:
        """``Trainer.maybe_grow`` on the replicated state (it touches only
        ``self.ts``); every rank sees the same alive count."""
        return loop.Trainer.maybe_grow(self, headroom, factor)

    def save_checkpoint(self, path: str, iteration: int):
        """``Trainer.save_checkpoint``'s file, written by rank 0 only."""
        if mesh_lib.rank() == 0:
            loop.Trainer.save_checkpoint(self, path, iteration)

    def restore_checkpoint(self, path: str) -> int:
        """Load a ``save_checkpoint`` file on every rank; the camera counter
        resumes at its iteration."""
        it = loop.Trainer.restore_checkpoint(self, path)
        self._camera_iter = it
        return it

    def sync_model(self):
        self.gaussians.params = self.ts.params
        self.gaussians.state = self.ts.gstate


def training_dp(scene, trainer: DPTrainer, iterations: int, log_every=100,
                progress=None):
    """The data-parallel ``training``: the camera stack consumed in batches
    of ``trainer.batch_size`` (the same ``default_rng(0)`` order on every
    rank); ``iterations`` counts cameras (reference iterations), not
    optimizer steps. Returns the logged metrics."""
    dev = trainer.mesh.device
    rng = np.random.default_rng(0)
    stack, cam_cache, gt_cache = [], {}, {}
    history = []
    while trainer._camera_iter < iterations:
        b = trainer.batch_size
        while len(stack) < b:
            stack.extend(rng.permutation(len(scene.get_train_cameras())))
        picks = [scene.get_train_cameras()[int(stack.pop())]
                 for _ in range(b)]
        for c in picks:
            if c.uid not in cam_cache:
                cam_cache[c.uid] = c.params(dev)
        # only this rank's ground truth goes to its device
        for c in picks[mesh_lib.batch_sharded(trainer.mesh, b)]:
            if c.uid not in gt_cache:
                gt_cache[c.uid] = torch.from_numpy(c.image).to(dev)
        cams = [cam_cache[c.uid] for c in picks]
        gts = [gt_cache.get(c.uid) for c in picks]
        metrics = trainer.step(cams, gts)
        it = trainer._camera_iter
        if it % log_every < b or it >= iterations:
            m = {k: float(v) for k, v in metrics.items() if k != "densify"}
            m["iter"] = it
            history.append(m)
            if progress:
                progress(m)
    trainer.sync_model()
    return history
