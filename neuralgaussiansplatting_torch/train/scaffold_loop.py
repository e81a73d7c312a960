"""Scaffold-GS training: the step and its host-side loop.

``scaffold_train_step`` is one render (``gaussian_renderer.render_scaffold``:
the anchors' prefilter, the MLP decode into neural Gaussians, the port's
rasterizer with the colours precomputed) -> loss -> backward -> one Adam
update over the anchors' leaves, the 12 MLP leaves and the appearance
embedding (one launch of the Adam kernel on the card). The loss is
Scaffold-GS's: (1 - lambda) L1 + lambda (1 - SSIM) + 0.01 x the mean over
the kept neural Gaussians of their scales' product. Nothing in it is read
back to the host.

``ScaffoldTrainer`` runs it with Scaffold-GS's per-group rates and
schedules (``ScaffoldOptimizationParams``: the anchor and offset rates
scaled by the scene extent; each schedule read at the iteration, as the
original's ``update_learning_rate(iteration)`` is), and every
``tune_interval`` iterations reads the binning demand back to re-bucket
the instance buffers, as ``Trainer`` does. The anchor set is fixed: the
original's anchor growing and pruning (iterations 1500-15000) are not
ported.

Under a profiler: "ngs.step" (``ScaffoldTrainer.step``), the render's
spans, "ngs.loss", "ngs.backward", "ngs.optimizer". ``steps`` counts the
trainer's steps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from neuralgaussiansplatting_torch import gaussian_renderer as gr
from neuralgaussiansplatting_torch.models import scaffold
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.train import loop, optim
from neuralgaussiansplatting_torch.utils import losses, timing

steps = 0  # ScaffoldTrainer steps since the caller last set it to 0


@dataclasses.dataclass(frozen=True)
class ScaffoldOptimizationParams:
    """Scaffold-GS's optimization arguments (``arguments/__init__.py``),
    with its defaults: each schedule decays log-linearly from its initial
    to its final rate over ``max_steps``."""

    position_lr_init: float = 0.0
    position_lr_final: float = 0.0
    offset_lr_init: float = 0.01
    offset_lr_final: float = 0.0001
    feature_lr: float = 0.0075
    scaling_lr: float = 0.007
    mlp_opacity_lr_init: float = 0.002
    mlp_opacity_lr_final: float = 0.00002
    mlp_cov_lr_init: float = 0.004
    mlp_cov_lr_final: float = 0.004
    mlp_color_lr_init: float = 0.008
    mlp_color_lr_final: float = 0.00005
    appearance_lr_init: float = 0.05
    appearance_lr_final: float = 0.0005
    max_steps: int = 30_000
    lambda_dssim: float = 0.2


def make_optimizer(opt: ScaffoldOptimizationParams, spatial_lr_scale: float,
                   num_cameras: int, first_iteration: int = 1) -> optim.Adam:
    """Adam (eps 1e-15) over the anchors' leaves, the MLPs and the
    embedding, with their groups' rates; a group's update number ``c``
    (from 0) is iteration ``first_iteration + c``, at which its schedule
    is read."""
    def sched(init, final, scale=1.0):
        f = optim.expon_lr_schedule(init * scale, final * scale,
                                    max_steps=opt.max_steps)
        return lambda count: f(count + first_iteration)

    mlp = {"mlp_opacity": (opt.mlp_opacity_lr_init, opt.mlp_opacity_lr_final),
           "mlp_cov": (opt.mlp_cov_lr_init, opt.mlp_cov_lr_final),
           "mlp_color": (opt.mlp_color_lr_init, opt.mlp_color_lr_final),
           "embedding_appearance": (opt.appearance_lr_init,
                                    opt.appearance_lr_final)}
    lrs = {"anchor": sched(opt.position_lr_init, opt.position_lr_final,
                           spatial_lr_scale),
           "offset": sched(opt.offset_lr_init, opt.offset_lr_final,
                           spatial_lr_scale),
           "anchor_feat": opt.feature_lr,
           "scaling": opt.scaling_lr}
    for name in scaffold.mlp_shapes(num_cameras):
        lrs[name] = sched(*mlp[name.split(".")[0]])
    return optim.Adam(lrs=lrs)


class ScaffoldTrainState(NamedTuple):
    params: scaffold.ScaffoldParams
    nets: dict              # {leaf: tensor}: the MLPs and the embedding
    opt_state: dict
    step: int


def scaffold_train_step(ts: ScaffoldTrainState, cam, view: int,
                        gt: torch.Tensor, bg: torch.Tensor, *,
                        tx: optim.Adam, settings: rast.RasterizeSettings,
                        anchor_capacity: int, lambda_dssim: float):
    """One render + loss + gradient + Adam step from training camera
    ``view``, the visible anchors decoded in ``anchor_capacity`` rows.
    Returns (new state, metrics); the metrics are tensors on the
    device."""
    leaves = {k: v.detach().requires_grad_()
              for k, v in (ts.params._asdict() | ts.nets).items()}
    params = scaffold.ScaffoldParams(
        *(leaves[k] for k in scaffold.ScaffoldParams._fields))
    nets = {k: leaves[k] for k in ts.nets}
    out = gr.render_scaffold(cam, view, params, nets, bg, settings,
                             anchor_capacity)
    with timing.span("ngs.loss"):
        loss = (losses.photometric_loss(out["render"], gt, lambda_dssim)
                + scaffold.SCALE_REG
                * scaffold.scale_regulariser(out["generated"]))
    with timing.span("ngs.backward"):
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    with timing.span("ngs.optimizer"):
        new, opt_state = tx.update(
            dict(zip(leaves, grads)), ts.opt_state,
            {k: v.detach() for k, v in leaves.items()})
    image = out["render"].detach()
    metrics = {
        "loss": loss.detach(),
        "psnr": losses.psnr(torch.clamp(image, 0, 1), gt),
        "visible_anchors": out["visible_anchors"],
        "neural_gaussians": out["neural_gaussians"],
        "anchor_overflow": out["anchor_overflow"],
        "rows": out["rows"],
        "visible": out["visible"],
        "gate": out["generated"].gate,
        "num_rendered": out["num_rendered"],
        "max_per_tile": out["max_per_tile"],
        "aligned_demand": out["aligned_demand"],
        "dropped": out["dropped"],
    }
    new_params = scaffold.ScaffoldParams(
        *(new[k] for k in scaffold.ScaffoldParams._fields))
    return ScaffoldTrainState(new_params, {k: new[k] for k in ts.nets},
                              opt_state, ts.step + 1), metrics


@dataclasses.dataclass
class ScaffoldTrainer:
    """Host-side orchestration of Scaffold-GS training on a fixed anchor
    set: the step from ``first_iteration`` on, the visible anchors decoded
    in ``anchor_capacity`` rows (``anchor_capacity_for`` of the most a
    view shows), and the instance buffers and the rows re-bucketed every
    ``tune_interval`` iterations, where the demand is read back."""

    params: scaffold.ScaffoldParams
    nets: dict
    anchor_capacity: int
    settings: rast.RasterizeSettings = rast.RasterizeSettings()
    opt: ScaffoldOptimizationParams = ScaffoldOptimizationParams()
    white_background: bool = False
    cameras_extent: float = 1.0
    first_iteration: int = 1
    tune_interval: int = 500
    min_capacity: int = 1 << 16
    max_capacity: int = 1 << 26

    def __post_init__(self):
        num_cameras = self.nets["embedding_appearance.weight"].shape[0]
        self.tx = make_optimizer(self.opt, self.cameras_extent, num_cameras,
                                 self.first_iteration)
        self.ts = ScaffoldTrainState(
            self.params, self.nets,
            self.tx.init(self.params._asdict() | self.nets), 0)
        dev = self.params.anchor.device
        self.bg = torch.tensor([1.0, 1.0, 1.0] if self.white_background
                               else [0.0, 0.0, 0.0], device=dev)
        self.iteration = self.first_iteration

    def step(self, cam, gt_image, view: int):
        """One iteration from training camera ``view`` (the embedding's
        row); returns the step's metrics (device tensors, with
        "retuned_capacity" / "retuned_anchor_capacity" where a tune point
        changed them)."""
        global steps
        with timing.span("ngs.step", self.iteration):
            self.ts, metrics = scaffold_train_step(
                self.ts, cam, view, gt_image, self.bg, tx=self.tx,
                settings=self.settings, lambda_dssim=self.opt.lambda_dssim,
                anchor_capacity=self.anchor_capacity)
            steps += 1
            if self.iteration % self.tune_interval == 0:
                self._tune(metrics)
            self.iteration += 1
            return metrics

    def _tune(self, metrics):
        """Re-bucket the instance buffers (``loop.tune_capacity``) and the
        rows (``anchor_capacity_for``, grown at once, shrunk below a
        quarter) to this step's demand: a read of the device."""
        settings, tuned = loop.tune_capacity(
            self.settings, int(metrics["num_rendered"]),
            int(metrics["aligned_demand"]), self.min_capacity,
            self.max_capacity)
        if tuned:
            self.settings = settings
            metrics["retuned_capacity"] = settings.capacity
        want = anchor_capacity_for(int(metrics["visible_anchors"])
                                   + int(metrics["anchor_overflow"]))
        if want > self.anchor_capacity or want < self.anchor_capacity // 4:
            self.anchor_capacity = want
            metrics["retuned_anchor_capacity"] = want


def anchor_capacity_for(visible: int) -> int:
    """Rows for ``visible`` anchors: 1.15 x, rounded up to a multiple of
    2^15."""
    return (int(visible * 1.15) // (1 << 15) + 1) * (1 << 15)
