"""Plain 3DGS training steps in PyTorch: render, L1 + 0.2 D-SSIM, autograd,
and Adam with the reference's per-group rates.

Adam follows the 3DGS training script's optimizer (Kerbl et al. 2023):
betas (0.9, 0.999), eps 1e-15, bias-corrected; the rates are the
reference's ``OptimizationParams`` defaults (``RATES``): features at
0.0025, the higher SH bands at a twentieth of it, opacity 0.05, scaling
0.005, rotation 0.001, and xyz on the exponential schedule from 1.6e-4 to
1.6e-6 times the scene extent over 30,000 steps, read at the step count
before each update. The 64 neural features of the fork's model are
trainable but never reach the image: their gradient is zero and Adam
leaves them where they are, so they are carried as zeros.
"""

from __future__ import annotations

import math

import torch

from ngsbench.reference import render as ref

B1, B2, EPS = 0.9, 0.999, 1e-15
RATES = {"features_dc": 0.0025, "features_rest": 0.0025 / 20.0,
         "scaling": 0.005, "rotation": 0.001, "opacity": 0.05}
XYZ_LR = (0.00016, 0.0000016, 30_000)    # init, final (x extent), steps
# the leaves the step updates, in the program's order; "features" (the
# neural features) has no path to the image
LEAVES = ("xyz", "features_dc", "features_rest", "features", "scaling",
          "rotation", "opacity")


def xyz_rate(count: int, extent: float) -> float:
    """The xyz learning rate before update ``count + 1``: a log-linear
    blend of the initial and final rates."""
    init, final, steps = XYZ_LR
    t = min(max(count / steps, 0.0), 1.0)
    return extent * math.exp(math.log(init) * (1 - t) + math.log(final) * t)


def steps(cloud: dict, cams, gts, bg, sh_degree: int, tile: int,
          extent: float, dtype=torch.float32, lambda_dssim: float = 0.2,
          loss_rows: int | None = None, pair_budget: int = ref.PAIR_BUDGET):
    """Train ``cloud`` one step per camera of ``cams`` against ``gts``.

    Returns {"loss": [per step], "grad_norm": {leaf: norm of the first
    step's gradient}, "change_norm": {leaf: norm of the parameters' change
    over all the steps}, "counts": [per step, ``render``'s counts],
    "params": {leaf: the parameters after the steps}}.
    ``loss_rows`` keeps the first rows of each image in the loss (a fault
    the checks must catch)."""
    params = {k: v.detach().to(dtype).clone() for k, v in cloud.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in params.items()}
    losses, counts, grad_norm = [], [], None
    for i, (cam, gt) in enumerate(zip(cams, gts)):
        img, _, _, c = ref.render(params, cam, sh_degree, bg, tile, dtype,
                                  counts=True, pair_budget=pair_budget)
        img = img.detach().requires_grad_()
        loss = ref.loss_fn(img, gt, lambda_dssim, loss_rows)
        (gimg,) = torch.autograd.grad(loss, [img])
        grads = ref.backward_image(params, cam, sh_degree, bg, tile, gimg,
                                   dtype, pair_budget)
        if i == 0:
            grad_norm = {k: float(g.float().norm()) for k, g in grads.items()}
        for k, g in grads.items():
            m, v = moments[k]
            m = B1 * m + (1 - B1) * g
            v = B2 * v + (1 - B2) * g * g
            moments[k] = (m, v)
            lr = xyz_rate(i, extent) if k == "xyz" else RATES[k]
            step = (m / (1 - B1 ** (i + 1))) / (
                torch.sqrt(v / (1 - B2 ** (i + 1))) + EPS)
            params[k] = params[k] - lr * step
        losses.append(float(loss.detach()))
        counts.append(c)
    change = {k: float((params[k].float() - cloud[k].float()).norm())
              for k in params}
    grad_norm["features"] = change["features"] = 0.0
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change,
            "counts": counts, "params": params}
