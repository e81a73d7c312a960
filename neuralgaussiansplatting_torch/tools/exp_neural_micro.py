"""Chained micro-timings of the neural (sw2) pipeline stages at 800^2 (the
demo cloud of 100k Gaussians, SH degree 3, seeded decoders).

Port of ``tools/exp_neural_micro.py``: the same rows, ids and names.

  [0] idxmap xla          the per-pixel sort oracle
                          (``idxmap.compute_idxmap``, capacity 2^22 pixel
                          instances)
  [1] idxmap tiled        K3 (``zbuffer_pallas.compute_idxmap_tiled``,
                          capacity 2^19 tile instances)
  [2] maps (tiled)        ``idxmap.render_idxmaps``: idxmap, feature and
                          depth maps
  [3] maps+unet           + the UNet
  [4] maps+cnn            + the kernel-predicting CNN
  [5] full render2 fwd    ``render2``
  [6] sw2 fwd+bwd step    ``neural_loop.neural_train_step`` (sw 2, Adam
                          over the features and the decoders)

Every row but [0] launches K3 once per step. The decoders are the port's
seeded ``init_decoders(0)``.

Timing: ``tools.chain_bench.chain``, 6 steps, best of 2. The JAX tool
chains inside one jit; here the steps run eagerly, so each figure is host
clock with the host's dispatch included (chained eager, host clock).

    python -m neuralgaussiansplatting_torch.tools.exp_neural_micro \\
        [row ids]

``main(argv)`` returns the rows with "timing", "launches" and "device".
Runs on the CUDA device, or on the CPU when ``NGS_PLATFORM=cpu``.
"""

from __future__ import annotations

from argparse import ArgumentParser
from types import SimpleNamespace

import torch

from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch import gaussian_renderer as gr
from neuralgaussiansplatting_torch.demo import demo_scene
from neuralgaussiansplatting_torch.ops import idxmap as idxmap_ops
from neuralgaussiansplatting_torch.ops.zbuffer_pallas import (
    compute_idxmap_tiled)
from neuralgaussiansplatting_torch.tools import _harness, _micro
from neuralgaussiansplatting_torch.tools.chain_bench import chain
from neuralgaussiansplatting_torch.train import neural_loop, optim

W = H = 800
N = 100_000
CAPACITY = 1 << 22   # the oracle: pixel instances (~4M at this scale)
TCAP = 1 << 19       # the tiled z-buffer: tile instances (~25x fewer)
ITERS, REPS = 6, 2
NAME_WIDTH = 20
STEP_ROW = "sw2 fwd+bwd step"
NO_COUNTERPART: dict = {}


def rows_for(params, state, cam) -> list:
    """The tool's rows, (name, make_body, carry), on the cloud
    ``(params, state)`` seen by ``cam``."""
    dev = params.xyz.device
    alive = state.alive
    nets = gr.init_decoders(0, device=dev)
    gt = torch.zeros((3, cam.height, cam.width), device=dev)

    def r_idx_xla(p, s):
        idx, depth, num_inst = idxmap_ops.compute_idxmap(
            p.xyz + s, cam, CAPACITY, alive)
        return _micro.sums(idx, depth) + num_inst

    def r_idx_tiled(p, s):
        idx, depth, num_inst = compute_idxmap_tiled(p.xyz + s, cam, TCAP,
                                                    alive)
        return _micro.sums(idx, depth) + num_inst

    def maps(p, s):
        return idxmap_ops.render_idxmaps(p.xyz + s, p.features, cam, TCAP,
                                         alive)

    def r_maps(p, s):
        m = maps(p, s)
        return _micro.sums(m.idxmap, m.featuremap, m.depthmap)

    def r_unet(p, s):
        return _micro.sums(nets["unet"](maps(p, s).featuremap))

    def r_cnn(p, s):
        return _micro.sums(nets["cnn"](maps(p, s).featuremap))

    def r_full2(p, s):
        out = gr.render2(cam, p._replace(xyz=p.xyz + s), nets, TCAP,
                         alive=alive)
        return _micro.sums(out["render"])

    def stage_row(fn):
        def make():
            def body(carry, s):
                with torch.no_grad():
                    return carry[0], carry[1] + fn(carry[0], s) * 1e-30
            return body
        return make

    # the fused fwd+bwd train step (the bench suite's neural workload)
    opt = optim.OptimizationParams()
    trainer = neural_loop.NeuralTrainer(
        SimpleNamespace(params=params, state=state), sw=2, opt=opt,
        capacity=TCAP)

    def make_step():
        def body(carry, s):
            ts, acc = carry
            ts2, metrics = neural_loop.neural_train_step(
                ts, cam, gt + s, sw=2, capacity=TCAP, txs=trainer.txs,
                lambda_dssim=opt.lambda_dssim)
            return ts2, acc + metrics["loss"] * 1e-30
        return body

    z = torch.zeros((), device=dev)
    return [(name, stage_row(fn), (params, z)) for name, fn in (
        ("idxmap xla", r_idx_xla), ("idxmap tiled", r_idx_tiled),
        ("maps (tiled)", r_maps), ("maps+unet", r_unet),
        ("maps+cnn", r_cnn), ("full render2 fwd", r_full2))] + [
        (STEP_ROW, make_step, (trainer.ts, z))]


def run(params, state, cam, selection=()) -> dict:
    """Chain and print the selected rows (every row when ``selection`` is
    empty); the step row also prints its Mpix/s. Returns the rows with
    "timing", "launches" and "device"."""
    before = _harness.launch_counts()
    rows = rows_for(params, state, cam)
    done = _micro.run_rows(rows[:-1], NO_COUNTERPART, NAME_WIDTH, selection,
                           iters=ITERS, reps=REPS)
    step = len(rows) - 1
    if not selection or str(step) in selection:
        _, make_step, carry = rows[step]
        ms = chain(make_step, carry, iters=ITERS, reps=REPS)
        print(f"  [{step}] {STEP_ROW:{NAME_WIDTH}s} {ms:8.2f} ms "
              f"({cam.width * cam.height / ms / 1e3:.2f} Mpix/s)",
              flush=True)
        done.append({"id": step, "name": STEP_ROW, "ms": ms,
                     "no_counterpart": None})
    return _micro.result(done, before, params.xyz.device)


def main(argv=None) -> dict:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="*")
    args = ap.parse_args(argv)
    params, state, cam = demo_scene(n=N, w=W, h=H, sh_degree=3,
                                    device=platform_device())
    return run(params, state, cam, args.rows)


if __name__ == "__main__":
    main()
