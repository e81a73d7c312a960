"""Classic 3DGS training: the step and the host-side schedule.

Port of ``train/loop.py``. ``train_step`` is one render -> L1+SSIM ->
backward -> per-group Adam -> densification-statistics step on the
tensors' device; ``train_steps`` is B of them over a stacked camera batch
(the multi-step dispatch); ``densify_step`` and ``reset_opacity_step`` are
the density-control rounds; ``Trainer`` runs the reference's schedule
around them (SH warm-up, densify window, opacity reset, capacity growth,
instance capacity re-bucketing and drop warnings), per iteration or per
block of iterations. None of them waits on the device, except the
``Trainer``'s capacity bookkeeping on its own cadence.

A step repeats bit for bit from the same state: nothing on its gradient
path sums in a run-dependent order (SSIM's convolutions set their own
cuDNN flags, see ``utils.losses``).

``Trainer.save_checkpoint`` / ``restore_checkpoint`` are the JAX
package's pickle checkpoint as ``torch.save`` of plain dicts of tensors
and ints (loaded with ``weights_only=True``); its orbax pair has no
counterpart. ``training(scene, ...)`` is the loop over a ``Scene``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.train import densify as dens
from neuralgaussiansplatting_torch.train import optim
from neuralgaussiansplatting_torch.utils import losses

# the leaves the step differentiates: every one the optimizer updates
# (``normals`` are frozen)
TRAINABLE = tuple(f for f in gm.GaussianParams._fields if f != "normals")


class TrainState(NamedTuple):
    params: gm.GaussianParams
    gstate: gm.GaussianState
    opt_state: dict
    step: int


def tune_capacity(settings: rast.RasterizeSettings, num_rendered: int,
                  aligned_demand: int, min_capacity: int = 1 << 16,
                  max_capacity: int = 1 << 23):
    """Re-bucket the instance buffers to the measured demand: grow at once
    (an overflow drops instances), shrink only past a comfortable slack.
    Returns (new_settings, changed)."""
    changed = False
    cap = settings.capacity
    want = max(min_capacity,
               1 << max(int(num_rendered * 1.4) - 1, 1).bit_length())
    want = min(want, max_capacity)
    if want > cap or want < cap // 4:
        settings = dataclasses.replace(settings, capacity=want)
        changed = True
    # the packed buffer is bucketed to 1/8ths between powers of two
    kcap = settings.packed_capacity or settings.capacity
    quantum = max(1 << max(int(aligned_demand * 1.25) - 1, 1).bit_length() - 3,
                  min_capacity // 8)
    kwant = min(max(min_capacity,
                    -(-int(aligned_demand * 1.25) // quantum) * quantum),
                max_capacity)
    if kwant > kcap or kwant < kcap // 2:
        settings = dataclasses.replace(settings, packed_capacity=kwant)
        changed = True
    return settings, changed


def train_step(ts: TrainState, cam, gt: torch.Tensor, bg: torch.Tensor, *,
               tx: optim.Adam, sh_degree: int,
               settings: rast.RasterizeSettings, lambda_dssim: float,
               mark=lambda stage: None):
    """One render + loss + gradient + Adam + statistics step.

    Returns (new TrainState, metrics); the metrics are tensors on the
    device (nothing is read back to the host here). ``mark(stage)`` is
    called after each stage: "forward" (render + loss), "backward",
    "optimizer" (dead-slot select, Adam, statistics).
    """
    params = ts.params
    n = params.xyz.shape[0]
    leaves = {f: getattr(params, f).detach().requires_grad_()
              for f in TRAINABLE}
    diff_params = params._replace(**leaves)
    offset = params.xyz.new_zeros((n, 2), requires_grad=True)

    out = render(cam, diff_params, ts.gstate.alive, sh_degree, bg, settings,
                 means2d_offset=offset)
    loss = losses.photometric_loss(out["render"], gt, lambda_dssim)
    mark("forward")
    inputs = list(leaves.values()) + [offset]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    mark("backward")
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    goff = grads.pop()

    # Dead (padding) slots carry no loss signal but can produce NaN
    # gradients through their degenerate parameters: a select (not a
    # multiply) clears them, so Adam never moves a slot until densification
    # writes it.
    alive = ts.gstate.alive
    grads = {f: torch.where(alive.reshape((n,) + (1,) * (g.ndim - 1)), g, 0.0)
             for f, g in zip(leaves, grads)}
    grads = params._replace(**grads)

    new_params, opt_state = tx.update(grads, ts.opt_state, params)
    gstate = dens.add_densification_stats(ts.gstate, out["radii"], goff)
    mark("optimizer")
    image = out["render"].detach()
    metrics = {
        "loss": loss.detach(),
        "psnr": losses.psnr(torch.clamp(image, 0, 1), gt),
        "num_rendered": out["num_rendered"],
        "max_per_tile": out["max_per_tile"],
        "aligned_demand": out["aligned_demand"],
        "dropped": out["dropped"],
        "culled": out["culled"],
        "radii_max": out["radii"].max(),
    }
    return TrainState(new_params, gstate, opt_state, ts.step + 1), metrics


def train_steps(ts: TrainState, cams, gts: torch.Tensor, bgs: torch.Tensor,
                *, tx: optim.Adam, sh_degree: int,
                settings: rast.RasterizeSettings, lambda_dssim: float):
    """B sequential ``train_step``s: camera i of the stacked ``cams``
    (``parallel.train_step.stack_cameras``), ground truth ``gts[i]`` of the
    (B, 3, H, W) stack and background ``bgs[i]`` of the (B, 3) one. The
    same state chain as B ``train_step`` calls, bit for bit. Nothing is
    read back to the host inside the block: each step's inputs are views
    of the stacks, and the metrics stay on the device, stacked along B
    once at the end. Returns (final TrainState, {name: (B,) tensor})."""
    steps = []
    for i in range(gts.shape[0]):
        ts, metrics = train_step(ts, cams.camera(i), gts[i], bgs[i], tx=tx,
                                 sh_degree=sh_degree, settings=settings,
                                 lambda_dssim=lambda_dssim)
        steps.append(metrics)
    return ts, {k: torch.stack([m[k] for m in steps]) for k in steps[0]}


def densify_step(ts: TrainState, generator: torch.Generator,
                 extent: float, *, cfg: optim.OptimizationParams,
                 use_size_prune: bool):
    params, gstate, opt_state, report = dens.densify_and_prune(
        ts.params, ts.gstate, ts.opt_state, generator,
        cfg.densify_grad_threshold, 0.005, extent, use_size_prune,
        cfg.percent_dense)
    return TrainState(params, gstate, opt_state, ts.step), report


def reset_opacity_step(ts: TrainState) -> TrainState:
    params, opt_state = dens.reset_opacity(ts.params, ts.opt_state)
    return TrainState(params, ts.gstate, opt_state, ts.step)


@dataclasses.dataclass
class Trainer:
    """Host-side orchestration of the reference's training schedule."""

    gaussians: gm.GaussianModel
    opt: optim.OptimizationParams = optim.OptimizationParams()
    settings: rast.RasterizeSettings = rast.RasterizeSettings()
    white_background: bool = False
    cameras_extent: float = 1.0
    seed: int = 0
    debug: bool = False          # snapshot and raise on a non-finite loss
    debug_from: int = -1         # ... from this iteration on (-1: always)
    snapshot_dir: str = "."
    auto_grow: bool = True
    auto_tune_capacity: bool = True   # re-bucket instance capacity to demand
    tune_interval: int = 500
    min_capacity: int = 1 << 16
    max_capacity: int = 1 << 23

    def __post_init__(self):
        params = self.gaussians.params
        self.tx = optim.make_optimizer(self.opt,
                                       self.gaussians.spatial_lr_scale)
        self.ts = TrainState(params=params, gstate=self.gaussians.state,
                             opt_state=self.tx.init(params), step=0)
        dev = params.xyz.device
        self.generator = torch.Generator(device=dev).manual_seed(self.seed)
        self.bg = torch.tensor([1.0, 1.0, 1.0] if self.white_background
                               else [0.0, 0.0, 0.0], device=dev)
        self._drop_warned = 0

    def _check_drops(self, metrics):
        """Warn about dropped instances; under dense expansion, double
        ``dense_cap`` (up to 64) instead."""
        dropped = int(metrics["dropped"])
        if dropped <= 0:
            return
        if self.settings.expand == "dense" and self.settings.dense_cap < 64:
            self.settings = dataclasses.replace(
                self.settings, dense_cap=self.settings.dense_cap * 2)
            metrics["retuned_dense_cap"] = self.settings.dense_cap
            print(f"[warn] {dropped} instances dropped under dense "
                  f"expansion; escalating dense_cap to "
                  f"{self.settings.dense_cap}")
        elif self._drop_warned < 8:
            self._drop_warned += 1
            print(f"[warn] {dropped} instances dropped "
                  f"(num_rendered={int(metrics['num_rendered'])}, "
                  f"aligned_demand={int(metrics['aligned_demand'])}, "
                  f"capacity={self.settings.capacity}, "
                  f"packed={self.settings.packed_capacity}); the rendered "
                  f"image is missing contributors. On densifying scenes the "
                  f"usual cause is buffer re-bucketing lagging demand "
                  f"spikes: set tune_interval to the densification "
                  f"interval; otherwise raise capacity/max_per_tile or "
                  f"check the initial splat sizes")

    def sync_model(self):
        """Reflect the training state back into the GaussianModel."""
        self.gaussians.params = self.ts.params
        self.gaussians.state = self.ts.gstate

    def step(self, cam, gt_image, iteration: int):
        """One iteration: ``grad_step`` then ``apply_schedule``. Callers that
        evaluate at milestones call those two with the evaluation between
        them, as the reference evaluates before density control."""
        metrics = self.grad_step(cam, gt_image, iteration)
        return self.apply_schedule(iteration, metrics)

    def grad_step(self, cam, gt_image, iteration: int):
        """SH warm-up, then one ``train_step``."""
        if iteration % 1000 == 0:
            self.gaussians.oneup_sh_degree()
        if self.opt.random_background:
            bg = torch.rand(3, generator=self.generator,
                            device=self.bg.device)
        else:
            bg = self.bg
        ts_in = self.ts
        self.ts, metrics = train_step(
            self.ts, cam, gt_image, bg, tx=self.tx,
            sh_degree=self.gaussians.active_sh_degree,
            settings=self.settings, lambda_dssim=self.opt.lambda_dssim)

        if self.debug and (self.debug_from < 0 or iteration >= self.debug_from):
            # reads the loss back: a wait on the device every iteration
            if not math.isfinite(metrics["loss"].item()):
                # the failing step is undone, so the snapshot holds its
                # inputs (the JAX package dumps the state after it)
                self.ts = ts_in
                path = os.path.join(self.snapshot_dir, "snapshot_fw.pt")
                self.dump_debug_snapshot(cam, gt_image, iteration, path)
                raise FloatingPointError(
                    f"non-finite loss at iteration {iteration}; inputs "
                    f"dumped to {path}")
        return metrics

    def apply_schedule(self, iteration: int, metrics):
        """Density control and capacity management for one iteration."""
        opt = self.opt
        if iteration < opt.densify_until_iter:
            if (iteration > opt.densify_from_iter
                    and iteration % opt.densification_interval == 0):
                use_size = iteration > opt.opacity_reset_interval
                self.ts, report = densify_step(
                    self.ts, self.generator, self.cameras_extent, cfg=opt,
                    use_size_prune=use_size)
                metrics["densify"] = report
            if iteration % opt.opacity_reset_interval == 0 or (
                    self.white_background
                    and iteration == opt.densify_from_iter):
                self.ts = reset_opacity_step(self.ts)
            if self.auto_grow and "densify" in metrics:
                if self.maybe_grow():
                    metrics["grew_capacity"] = self.ts.params.xyz.shape[0]

        if self.auto_tune_capacity and iteration % self.tune_interval == 0:
            new_settings, tuned = tune_capacity(
                self.settings, int(metrics["num_rendered"]),
                int(metrics["aligned_demand"]),
                self.min_capacity, self.max_capacity)
            if tuned:
                self.settings = new_settings
                metrics["retuned_capacity"] = new_settings.capacity
            self._check_drops(metrics)
        return metrics

    def step_block(self, cams, gts, first_iteration: int):
        """``B = gts.shape[0]`` sequential iterations from
        ``first_iteration`` through ``train_steps``: the same step chain as
        B ``step`` calls. Schedule events whose iteration falls inside the
        block are applied at its edges (SH warm-up before it, density
        control and capacity tuning after it), so the run matches
        per-iteration stepping when the block size divides their intervals.
        ``cams`` is a stacked ``CameraParams``. Callers that evaluate at
        milestones call ``grad_step_block`` -> evaluation ->
        ``apply_schedule_block``, as with ``step``."""
        b = int(gts.shape[0])
        metrics = self.grad_step_block(cams, gts, first_iteration)
        return self.apply_schedule_block(
            first_iteration, first_iteration + b - 1, metrics)

    def grad_step_block(self, cams, gts, first_iteration: int):
        """The gradient phase of ``step_block``: SH warm-up if an iteration
        of the block is a multiple of 1000, then ``train_steps``. With
        ``random_background`` one (B, 3) draw from the trainer's generator
        serves the block (not bit-equal to B per-iteration draws, as in the
        JAX package). Returns the last step's metrics. (``debug`` is
        checked per iteration only, by ``grad_step``.)"""
        b = int(gts.shape[0])
        if any(i % 1000 == 0
               for i in range(first_iteration, first_iteration + b)):
            self.gaussians.oneup_sh_degree()
        if self.opt.random_background:
            bgs = torch.rand((b, 3), generator=self.generator,
                             device=self.bg.device)
        else:
            bgs = self.bg.expand(b, 3)
        self.ts, stacked = train_steps(
            self.ts, cams, gts, bgs, tx=self.tx,
            sh_degree=self.gaussians.active_sh_degree,
            settings=self.settings, lambda_dssim=self.opt.lambda_dssim)
        return {k: v[-1] for k, v in stacked.items()}

    def apply_schedule_block(self, it0: int, it1: int, metrics):
        """Density control and capacity management after the block of
        iterations ``it0..it1`` (inclusive), on ``apply_schedule``'s tests
        taken over the block: densify if any iteration qualifies (the size
        prune once ``it1`` passes the opacity-reset interval), reset the
        opacity if any iteration is a reset iteration (or, on a white
        background, the block holds ``densify_from_iter``), tune if any
        iteration is a tune iteration."""
        block = range(it0, it1 + 1)
        opt = self.opt
        if it0 < opt.densify_until_iter:
            if any(i > opt.densify_from_iter
                   and i % opt.densification_interval == 0 for i in block):
                use_size = it1 > opt.opacity_reset_interval
                self.ts, report = densify_step(
                    self.ts, self.generator, self.cameras_extent, cfg=opt,
                    use_size_prune=use_size)
                metrics["densify"] = report
            if any(i % opt.opacity_reset_interval == 0 for i in block) or (
                    self.white_background
                    and it0 <= opt.densify_from_iter <= it1):
                self.ts = reset_opacity_step(self.ts)
            if self.auto_grow and "densify" in metrics:
                if self.maybe_grow():
                    metrics["grew_capacity"] = self.ts.params.xyz.shape[0]

        if self.auto_tune_capacity and any(
                i % self.tune_interval == 0 for i in block):
            new_settings, tuned = tune_capacity(
                self.settings, int(metrics["num_rendered"]),
                int(metrics["aligned_demand"]),
                self.min_capacity, self.max_capacity)
            if tuned:
                self.settings = new_settings
                metrics["retuned_capacity"] = new_settings.capacity
            self._check_drops(metrics)
        return metrics

    def maybe_grow(self, headroom: float = 0.85, factor: int = 2) -> bool:
        """Double every per-Gaussian tensor (parameters, statistics, Adam
        moments) once densification fills ``headroom`` of the capacity."""
        alive = int(self.ts.gstate.alive.sum())
        cap = self.ts.params.xyz.shape[0]
        if alive < headroom * cap:
            return False
        params, gstate = gm.repad(self.ts.params, self.ts.gstate,
                                  cap * factor)

        def grow(a):
            return torch.cat([a, a.new_zeros((cap * (factor - 1),)
                                             + a.shape[1:])])

        opt_state = {name: optim.AdamGroup(grow(g.mu), grow(g.nu), g.count)
                     for name, g in self.ts.opt_state.items()}
        self.ts = TrainState(params, gstate, opt_state, self.ts.step)
        return True

    def dump_debug_snapshot(self, cam, gt, iteration: int, path: str) -> str:
        """Write the failing step's whole input (camera, ground truth,
        parameters, state, SH degree) with ``torch.save`` for an offline
        repeat; ``torch.load(path, weights_only=True)`` reads it."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "iteration": iteration,
            "cam": {"view": cam.view.cpu(), "full_proj": cam.full_proj.cpu(),
                    "campos": cam.campos.cpu(), "tan_fovx": cam.tan_fovx,
                    "tan_fovy": cam.tan_fovy, "width": cam.width,
                    "height": cam.height},
            "gt": gt.detach().cpu(),
            "params": _host(self.ts.params),
            "gstate": _host(self.ts.gstate),
            "active_sh_degree": self.gaussians.active_sh_degree,
        }
        torch.save(payload, path)
        return path

    def save_checkpoint(self, path: str, iteration: int):
        """The whole training state at ``iteration`` (parameters, state,
        Adam moments and counts, SH degree, spatial learning-rate scale)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "iteration": iteration,
            "active_sh_degree": self.gaussians.active_sh_degree,
            "spatial_lr_scale": self.gaussians.spatial_lr_scale,
            "params": _host(self.ts.params),
            "gstate": _host(self.ts.gstate),
            "opt_state": {name: {"mu": g.mu.detach().cpu(),
                                 "nu": g.nu.detach().cpu(),
                                 "count": g.count}
                          for name, g in self.ts.opt_state.items()},
        }
        torch.save(payload, path)

    def restore_checkpoint(self, path: str) -> int:
        """Load a ``save_checkpoint`` file onto the trainer's device;
        returns its iteration. The optimizer is rebuilt for the file's
        spatial learning-rate scale (the JAX package keeps the one the
        trainer was made with)."""
        dev = self.ts.params.xyz.device
        payload = torch.load(path, map_location=dev, weights_only=True)
        self.gaussians.active_sh_degree = payload["active_sh_degree"]
        self.gaussians.spatial_lr_scale = payload["spatial_lr_scale"]
        self.tx = optim.make_optimizer(self.opt, payload["spatial_lr_scale"])
        iteration = payload["iteration"]
        self.ts = TrainState(
            params=gm.normalize_params(
                gm.GaussianParams(**payload["params"])),
            gstate=gm.GaussianState(**payload["gstate"]),
            opt_state={name: optim.AdamGroup(g["mu"], g["nu"], g["count"])
                       for name, g in payload["opt_state"].items()},
            step=iteration)
        self.sync_model()
        return iteration


def _host(nt) -> dict:
    """{field: host tensor} of a NamedTuple of tensors."""
    return {k: v.detach().cpu() for k, v in nt._asdict().items()}


def training(scene, trainer: Trainer, iterations: int,
             save_iterations=(), checkpoint_iterations=(),
             log_every: int = 100, progress=None):
    """The loop over a ``Scene``: cameras in the order of
    ``np.random.default_rng(trainer.seed)`` permutations, ground truth and
    camera tensors cached on the trainer's device, the model saved and
    checkpointed at the given iterations. Returns the logged metrics (every
    ``log_every`` iterations and the last), each also passed to
    ``progress``."""
    dev = trainer.ts.params.xyz.device
    rng = np.random.default_rng(trainer.seed)
    stack = []
    cam_cache, gt_cache = {}, {}
    history = []
    t0 = time.time()
    for iteration in range(1, iterations + 1):
        if not stack:
            stack = list(rng.permutation(len(scene.get_train_cameras())))
        cam = scene.get_train_cameras()[stack.pop()]
        cp = cam_cache.get(cam.uid)
        if cp is None:
            cp = cam_cache[cam.uid] = cam.params(dev)
        gt = gt_cache.get(cam.uid)
        if gt is None:
            gt = gt_cache[cam.uid] = torch.from_numpy(cam.image).to(dev)

        metrics = trainer.step(cp, gt, iteration)
        if iteration % log_every == 0 or iteration == iterations:
            m = {k: float(v) for k, v in metrics.items() if k != "densify"}
            m["iter"] = iteration
            m["elapsed"] = time.time() - t0
            m["alive"] = int(trainer.ts.gstate.alive.sum())
            history.append(m)
            if progress:
                progress(m)
        if iteration in save_iterations:
            trainer.sync_model()
            scene.save(iteration)
        if iteration in checkpoint_iterations:
            trainer.save_checkpoint(
                os.path.join(scene.model_path, f"chkpnt{iteration}.ckpt"),
                iteration)
    trainer.sync_model()
    return history
