"""Data-parallel scaling harness: the DP training step at world sizes 1, 2
and 4.

Port of ``tools/bench_scaling.py``. Each world size W starts W processes
(``torch.distributed``, one per device, a ``file://`` store), each holding
a replica of a demo cloud and rendering one camera per step, so the work
per process stays fixed while the batch grows with W
(``parallel.train_step.make_dp_train_step``: one backward per process,
the gradient sums through ``all_reduce``). Rank 0 reports the step time
and the cameras per second; the scaling efficiency is the cameras per
second per process against the one-process run.

On the CPU (``--device cpu``: gloo between processes that share this
host's cores) the numbers are correctness-grade only, as the JAX tool says
of its virtual devices: they check the step's structure, not a cluster's
throughput. On a host with W or more GPUs, ``--device cuda`` (the default)
runs NCCL between them; a world larger than the GPU count is skipped.

    python -m neuralgaussiansplatting_torch.tools.bench_scaling \\
        [--device cpu] [--worlds 1 2 4] [--iters 5] [--n 20000] [--size 128]

Prints one JSON line per world size, then one with the efficiencies;
``main`` returns them.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import tempfile
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--worlds", nargs="+", type=int, default=[1, 2, 4])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--size", type=int, default=128)
    return ap.parse_args(argv)


def _worker(rank: int, world: int, store: str, args, results):
    """One rank: the DP step on its one camera, ``args.iters`` times after a
    warm-up; rank 0 puts (step ms) on ``results``."""
    import torch
    import torch.distributed as dist

    from neuralgaussiansplatting_torch import demo
    from neuralgaussiansplatting_torch.ops import rasterize as rast
    from neuralgaussiansplatting_torch.parallel import distributed
    from neuralgaussiansplatting_torch.parallel import train_step as pts
    from neuralgaussiansplatting_torch.train import optim
    from neuralgaussiansplatting_torch.train.loop import TrainState

    torch.set_num_threads(1)
    device = torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", rank)
    distributed.initialize(init_method=f"file://{store}", world_size=world,
                           rank=rank, device=device)
    try:
        mesh = distributed.make_global_mesh(device=device)
        params, state, cam = demo.demo_scene(
            n=args.n, w=args.size, h=args.size, sh_degree=2, device=device)
        settings = rast.make_settings("seq", capacity=1 << 18,
                                      max_per_tile=2048, fast_sort=True)
        tx = optim.make_optimizer(optim.OptimizationParams(), 1.0)
        ts = TrainState(params, state, tx.init(params), 0)
        cams, gts = pts.shard_batch(
            mesh, pts.stack_cameras([cam] * world),
            torch.zeros((world, 3, cam.height, cam.width), device=device))
        step = pts.make_dp_train_step(mesh, tx, sh_degree=2,
                                      settings=settings)
        bg = torch.zeros(3, device=device)
        ts, m = step(ts, cams, gts, bg)
        m["loss"].item()                        # warm-up, synchronised
        t0 = time.perf_counter()
        for _ in range(args.iters):
            ts, m = step(ts, cams, gts, bg)
        m["loss"].item()
        if rank == 0:
            results.put((time.perf_counter() - t0) / args.iters * 1e3)
    finally:
        dist.destroy_process_group()


def run_world(world: int, args) -> float:
    """Step ms of rank 0 in a world of ``world`` processes."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker,
                             args=(r, world, store, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            step_ms = results.get(timeout=600)
        finally:
            for p in procs:
                p.join(timeout=120)
                if p.is_alive():
                    p.kill()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"world {world}: worker exit codes {bad}")
    return step_ms


def main(argv=None) -> dict:
    args = parse_args(argv)
    available = os.cpu_count() if args.device == "cpu" else None
    if args.device == "cuda":
        import torch
        from neuralgaussiansplatting_torch import resolve_device
        resolve_device("cuda")
        available = torch.cuda.device_count()
    rows = []
    for world in args.worlds:
        if world > available:
            print(f"# skipping world {world} ({available} {args.device} "
                  f"devices)")
            continue
        step_ms = run_world(world, args)
        rows.append({"world": world, "batch": world, "step_ms": step_ms,
                     "cams_per_s": world / step_ms * 1e3})
        print(json.dumps(rows[-1]), flush=True)
    for r in rows:
        r["scaling_efficiency"] = (r["cams_per_s"] / r["world"]) / (
            rows[0]["cams_per_s"] / rows[0]["world"])
    out = {"device": args.device,
           "correctness_grade_only": args.device == "cpu",
           "note": ("gloo between CPU processes on one host: collectives "
                    "are memory copies and the processes share its cores; "
                    "use only to check the step's structure"
                    if args.device == "cpu" else "NCCL between GPUs"),
           "model": {"n": args.n, "size": args.size}, "rows": rows}
    print(json.dumps({"efficiency": [r["scaling_efficiency"]
                                     for r in rows]}))
    return out


if __name__ == "__main__":
    main()
