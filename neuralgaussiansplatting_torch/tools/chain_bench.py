"""Chained-iteration benchmark: per-iteration time of a step fed its own
output.

Port of ``tools/chain_bench.py``. ``chain`` applies a step ``iters`` times,
each step taking the previous one's carry, synchronises once on the carry's
device, and turns the best of ``reps`` runs, less the best one-step run,
into milliseconds per iteration: the rate at which back-to-back steps go
through the card, host dispatch included. The configurations are the JAX
tool's, on the port's paths: the classic render and training step at
800x800 and 1920x1080 (100k Gaussians, SH degree 3) on the seq (K1/K2) and
pallas (K4/K5) routes, and the neural render2 training step (K3) in float32
and bfloat16.

    python -m neuralgaussiansplatting_torch.tools.chain_bench [config]
"""

from __future__ import annotations

import argparse
import time

import torch

from neuralgaussiansplatting_torch import resolve_device

# what a chained time is in the port: eager steps, host clock over runs
# that each end in one synchronisation (the bench tools' "timing" key)
TIMING = "chained eager, host clock"
CONFIGS = ("classic_fb", "classic_fb_seq", "classic_fwd_seq",
           "classic_fwd1080_seq", "classic_fwd1080", "neural_fb",
           "neural_fb_bf16")
REPS = 3   # timed runs of each length, as in the JAX tool


def iters_for(which: str) -> int:
    """Chained steps per run of configuration ``which`` (the JAX tool's)."""
    return 6 if which.startswith("neural") else 8


def _leaves(x) -> list:
    """The tensors of a carry: a tensor, a module's parameters, or those of
    a tuple, list or dict of carries; a host number or None holds none."""
    if x is None or isinstance(x, (int, float)):
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.nn.Module):
        return list(x.parameters())
    if isinstance(x, dict):
        x = list(x.values())
    return [leaf for item in x for leaf in _leaves(item)]


def chain(make_body, x0, iters: int = 8, reps: int = 3) -> float:
    """Milliseconds per iteration of ``body = make_body()``, a function
    (carry, eps) -> carry applied ``iters`` times from ``x0``.

    ``eps`` is a tiny per-iteration float (i * 1e-30), as in the JAX tool,
    which folds it into its inputs so that XLA cannot collapse the loop;
    the port runs eagerly, and a body may ignore it. Each run ends in one
    synchronisation: a checksum that reads every leaf of the final carry.
    The body runs (reps + 1) * (iters + 1) times: one warm-up of each
    length, then ``reps`` timed runs of each.
    """
    body = make_body()

    def run(s: float, n: int) -> float:
        x = x0
        for i in range(n):
            x = body(x, s + i * 1e-30)
        with torch.no_grad():
            return float(sum(leaf.reshape(-1)[::max(1, leaf.numel() // 64)]
                             .float().sum() for leaf in _leaves(x)))

    run(0.0, iters)
    run(0.0, 1)

    def timed(s: float, n: int) -> float:
        t0 = time.perf_counter()
        run(s, n)
        return time.perf_counter() - t0

    tn = min(timed(r + 1, iters) for r in range(reps))
    t1 = min(timed(r + 9, 1) for r in range(reps))
    return (tn - t1) / (iters - 1) * 1e3


def descend(params, grads):
    """params - 1e-30 * grads, leaf by leaf (a leaf without a gradient
    stays)."""
    return type(params)(*(p if g is None else (p - 1e-30 * g).detach()
                          for p, g in zip(params, grads)))


def fwd_bwd_body(cam, alive, sh_degree: int, settings, gt: torch.Tensor,
                 lambda_dssim: float = 0.2):
    """A chain body (params, eps) -> params: one ``render`` with
    ``settings``, L1+SSIM against ``gt + eps``, the backward, and
    ``descend`` (the JAX tools' chained training step)."""
    from neuralgaussiansplatting_torch import gaussian_renderer as gr
    from neuralgaussiansplatting_torch.models import gaussians as gm
    from neuralgaussiansplatting_torch.utils import losses

    bg = torch.zeros(3, device=gt.device)

    def body(p, s):
        leaves = [a.detach().requires_grad_() for a in p]
        out = gr.render(cam, gm.GaussianParams(*leaves), alive, sh_degree, bg,
                        settings)
        loss = losses.photometric_loss(out["render"], gt + s, lambda_dssim)
        return descend(p, torch.autograd.grad(loss, leaves,
                                               allow_unused=True))
    return body


def forward_body(cam, alive, sh_degree: int, settings):
    """A chain body (params, image) -> (params, image): one render without
    gradients whose means are shifted by 1e-30 x the previous image's mean
    plus eps. The dependency runs through xyz, so preprocess, binning and
    the sort are inside each step, as in the JAX tools."""
    from neuralgaussiansplatting_torch import gaussian_renderer as gr

    bg = torch.zeros(3, device=alive.device)

    def body(carry, s):
        p, fb = carry
        with torch.no_grad():
            out = gr.render(cam, p._replace(
                xyz=p.xyz + (1e-30 * fb.mean() + s)), alive, sh_degree, bg,
                settings)
        return p, out["render"]
    return body


def neural_fwd_bwd_body(cam, gt: torch.Tensor, capacity: int,
                        dtype=torch.float32):
    """A chain body (params, decoders) -> (params, decoders): one
    ``render2`` with z-buffer ``capacity``, L1+SSIM (lambda 0.2) against
    ``gt + eps``, the backward, and both stepped by -1e-30 x their
    gradients (the JAX tools' chained neural training step)."""
    from neuralgaussiansplatting_torch import gaussian_renderer as gr
    from neuralgaussiansplatting_torch.models import gaussians as gm
    from neuralgaussiansplatting_torch.utils import losses

    def body(carry, s):
        p, nets = carry
        leaves = [a.detach().requires_grad_() for a in p]
        weights = [w for m in nets.values() for w in m.parameters()]
        out = gr.render2(cam, gm.GaussianParams(*leaves), nets,
                         capacity=capacity, dtype=dtype)
        loss = losses.photometric_loss(out["render"], gt + s, 0.2)
        grads = torch.autograd.grad(loss, leaves + weights,
                                    allow_unused=True)
        with torch.no_grad():
            for w, g in zip(weights, grads[len(leaves):]):
                if g is not None:
                    w.sub_(1e-30 * g)
        return descend(p, grads[:len(leaves)]), nets
    return body


def run(which: str, device="cuda") -> float:
    """Build configuration ``which`` on ``device``, chain it and print its
    line; returns ms per iteration."""
    from neuralgaussiansplatting_torch import demo
    from neuralgaussiansplatting_torch import gaussian_renderer as gr
    from neuralgaussiansplatting_torch.ops import rasterize as rast

    if which not in CONFIGS:
        raise ValueError(f"unknown config {which!r}; one of {CONFIGS}")
    dev = resolve_device(device)
    iters = iters_for(which)

    if which.startswith("neural"):
        dtype = torch.bfloat16 if which.endswith("bf16") else torch.float32
        params, _, cam = demo.demo_scene(n=100_000, w=800, h=800,
                                         sh_degree=1, device=dev)
        nets = gr.init_decoders(0, device=dev)
        gt = torch.zeros((3, 800, 800), device=dev)

        t = chain(lambda: neural_fwd_bwd_body(cam, gt, 1 << 21, dtype),
                  (params, nets), iters=iters, reps=REPS)
        print("neural2 fwd+bwd 800^2 (%s): %7.1f ms  (%5.2f Mpix/s)"
              % (str(dtype).removeprefix("torch."), t, 800 * 800 / t / 1e3),
              flush=True)
        return t

    w, h = (1920, 1080) if "1080" in which else (800, 800)
    params, state, cam = demo.demo_scene(n=100_000, w=w, h=h, sh_degree=3,
                                         device=dev)
    alive = state.alive
    settings = {
        "classic_fb": rast.RasterizeSettings(
            capacity=1216 * 1024, max_per_tile=2048, chunk=128,
            backend="pallas", fast_sort=True, tight_culling=True,
            precise_cull=True, packed_capacity=1152 * 1024),
        "classic_fb_seq": rast.RasterizeSettings(
            block_x=32, block_y=32, capacity=512 * 1024, max_per_tile=4096,
            chunk=128, backend="seq", fast_sort=True, tight_culling=True,
            precise_cull=True, packed_capacity=512 * 1024),
        "classic_fwd1080_seq": rast.RasterizeSettings(
            block_x=32, block_y=32, capacity=1 << 21, max_per_tile=8192,
            chunk=128, backend="seq", fast_sort=True, tight_culling=True,
            precise_cull=True, packed_capacity=1 << 21,
            track_contrib=False),
        "classic_fwd1080": rast.RasterizeSettings(
            capacity=1 << 22, max_per_tile=2048, chunk=128,
            backend="pallas", fast_sort=True, tight_culling=True),
    }
    settings["classic_fwd_seq"] = settings["classic_fb_seq"]
    settings = settings[which]

    if which in ("classic_fb", "classic_fb_seq"):
        gt = torch.zeros((3, h, w), device=dev)
        t = chain(lambda: fwd_bwd_body(cam, alive, 3, settings, gt), params,
                  iters=iters, reps=REPS)
        label = ("classic fwd+bwd 800^2 100k SH3:" if which == "classic_fb"
                 else "seq fwd+bwd 800^2 100k SH3:  ")
        print("%s %7.1f ms  (%5.2f Mpix/s)" % (label, t, w * h / t / 1e3),
              flush=True)
        return t

    t = chain(lambda: forward_body(cam, alive, 3, settings),
              (params, torch.zeros((3, h, w), device=dev)),
              iters=iters, reps=REPS)
    if which == "classic_fwd_seq":
        print("seq fwd 800^2 100k SH3:       %7.1f ms  (%5.2f Mpix/s)"
              % (t, w * h / t / 1e3), flush=True)
    else:
        label = ("seq fwd 1080p 100k SH3:      " if which.endswith("seq")
                 else "classic fwd 1080p 100k SH3:  ")
        print("%s %7.1f ms  (%5.2f fps)" % (label, t, 1000 / t), flush=True)
    return t


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config", nargs="?", default="classic_fb",
                        choices=CONFIGS)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return run(args.config, args.device)


if __name__ == "__main__":
    main()
