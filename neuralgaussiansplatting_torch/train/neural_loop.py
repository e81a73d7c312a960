"""Neural-feature training: the step and its host-side loop.

Port of ``train/neural_loop.py`` (the reference's ``trainn.py``). ``sw``
selects the render path (1, 2 or 3, as ``trainn.py``'s switch does).
Geometry is frozen, as the z-buffer returns no geometry gradient: only the
64-d per-Gaussian ``features`` (dims 25..63 reach the loss) and the
screen-space decoders train, all by Adam (eps 1e-15) at ``feature_lr``.
Densification is off, as in the reference.

Under a profiler the step opens the spans "ngs.step" (``NeuralTrainer.step``),
the render's (``gaussian_renderer.render1/2/3``), "ngs.loss", "ngs.backward"
and "ngs.optimizer" (``neural_train_step``).

The step's hand-written kernels: K3 in the z-buffer, which has no
backward; the denoiser's pair (``ops/denoise``), one launch each way; and
the Adam kernel, three launches. The features' gradient comes from the
winner-row gather's exact per-Gaussian sum, the decoders' from their
convolutions' own backward.

The decoders are ``nn.Module``s and the step updates their parameters in
place (a copy of each updated tensor into it); ``features`` is replaced,
as the JAX step replaces every leaf.

A step repeats bit for bit from the same state on the card: its forward
and backward run with cuDNN restricted to deterministic algorithms (the
decoders' weight gradients otherwise may take ones that add with atomics),
and the denoiser's backward kernel adds in a fixed order without atomics
(as the plain version's reflect padding, ``nets._reflect_pad``, does).
TF32 stays as PyTorch sets it (deterministic).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from neuralgaussiansplatting_torch import gaussian_renderer as gr
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.train import optim
from neuralgaussiansplatting_torch.utils import losses, timing


class NeuralTrainState(NamedTuple):
    params: gm.GaussianParams
    net_params: dict        # {"mlp", "unet", "cnn", "pure_cnn"}: nn.Modules
    opt_state: tuple        # (features' Adam state, decoders' Adam state)
    step: int
    alive: torch.Tensor | None = None   # capacity-padding mask


RENDER_FNS = {1: gr.render1, 2: gr.render2, 3: gr.render3}


def decoder_leaves(net_params: dict) -> dict:
    """{"<decoder>.<parameter>": parameter} of every decoder."""
    return {f"{key}.{name}": p for key, module in net_params.items()
            for name, p in module.named_parameters()}


def make_neural_optimizer(opt: optim.OptimizationParams, net_params: dict):
    """(Adam over ``features``, Adam over every decoder parameter), both at
    ``feature_lr``; every other Gaussian leaf is frozen."""
    return (optim.Adam(lrs={"features": opt.feature_lr}),
            optim.Adam(lrs={name: opt.feature_lr
                            for name in decoder_leaves(net_params)}))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms inside the block (its
    TF32 switch untouched); the flag is global, so the backward, which
    runs in autograd's device thread, sees it too."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = saved


def neural_train_step(ts: NeuralTrainState, cam, gt: torch.Tensor, *,
                      sw: int, capacity: int, txs, lambda_dssim: float,
                      dtype=torch.float32):
    """One render -> L1+SSIM -> backward -> Adam step of the features and
    the decoders. Returns (new state, metrics); the metrics are tensors on
    the device: loss, psnr, hit_rate and idx_demand (the z-buffer's
    demand, for the capacity autotune)."""
    gaussian_tx, net_tx = txs
    features = ts.params.features.detach().requires_grad_()
    leaves = decoder_leaves(ts.net_params)
    inputs = [features, *leaves.values()]
    with deterministic_cudnn():
        out = RENDER_FNS[sw](cam, ts.params._replace(features=features),
                             ts.net_params, capacity, dtype=dtype,
                             alive=ts.alive)
        with timing.span("ngs.loss"):
            loss = losses.photometric_loss(out["render"], gt, lambda_dssim)
        with timing.span("ngs.backward"):
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)

    g_state, n_state = ts.opt_state
    with torch.no_grad():
        with timing.span("ngs.optimizer"):
            params, g_state = gaussian_tx.update({"features": grads[0]},
                                                 g_state, ts.params)
            new_leaves, n_state = net_tx.update(
                dict(zip(leaves, grads[1:])), n_state,
                {name: p.detach() for name, p in leaves.items()})
            for name, p in leaves.items():
                p.copy_(new_leaves[name])
        image = out["render"].detach()
        metrics = {
            "loss": loss.detach(),
            "psnr": losses.psnr(torch.clamp(image, 0, 1), gt),
            "hit_rate": (out["idxmap"] >= 0).float().mean(),
            "idx_demand": out["num_inst"],
        }
    return NeuralTrainState(params, ts.net_params, (g_state, n_state),
                            ts.step + 1, ts.alive), metrics


class NeuralTrainer:
    """Host-side orchestration of the neural pipeline (``trainn.py``'s
    loop): the step, and every 100 steps the z-buffer capacity autotune
    (1.4x headroom to the next power of two, within [2^16, 2^24])."""

    def __init__(self, gaussians: gm.GaussianModel, sw: int = 2,
                 opt: optim.OptimizationParams = optim.OptimizationParams(),
                 capacity: int = 1 << 20, seed: int = 0,
                 mixed_precision: bool = False):
        self.gaussians = gaussians
        self.sw = sw
        self.opt = opt
        self.capacity = capacity
        self.dtype = torch.bfloat16 if mixed_precision else torch.float32
        self.net_params = gr.init_decoders(
            seed, device=gaussians.params.xyz.device)
        self.txs = make_neural_optimizer(opt, self.net_params)
        self.ts = NeuralTrainState(
            params=gaussians.params, net_params=self.net_params,
            opt_state=(self.txs[0].init(gaussians.params),
                       self.txs[1].init(decoder_leaves(self.net_params))),
            step=0, alive=gaussians.state.alive)

    def step(self, cam, gt_image):
        with timing.span("ngs.step", self.ts.step + 1):
            self.ts, metrics = neural_train_step(
                self.ts, cam, gt_image, sw=self.sw, capacity=self.capacity,
                txs=self.txs, lambda_dssim=self.opt.lambda_dssim,
                dtype=self.dtype)
            # read the demand back (a wait on the device) only on the
            # cadence; the 1.4x headroom covers growth between checks
            if self.ts.step % 100 == 0:
                demand = int(metrics["idx_demand"])
                want = 1 << max(int(demand * 1.4) - 1, 1).bit_length()
                want = min(max(want, 1 << 16), 1 << 24)
                if want > self.capacity or want < self.capacity // 4:
                    self.capacity = want
                    metrics["retuned_idx_capacity"] = want
            return metrics

    def sync_model(self):
        """Reflect the training state back into the GaussianModel."""
        self.gaussians.params = self.ts.params
        self.net_params = self.ts.net_params
