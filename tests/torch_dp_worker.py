"""Worker of ``test_torch_parallel.py``'s two-process gloo test.

    python tests/torch_dp_worker.py <rank> <world> <init file> <out dir>

Joins a gloo group through a ``file://`` store, runs the port's
``DPTrainer`` on ``<out dir>/inputs.npz`` (``dp_inputs``: a batch of 4
cameras, 2 per rank) for ``STEPS`` steps with densification off and again
with it on, has rank 0 write the second run's checkpoint, and prints a
checksum of each run's final state; rank 0 also saves the first run's
losses and positions to ``<out dir>/world2.npz``. Imports no JAX.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)

STEPS = 10


def dp_inputs(cams, means, gts) -> dict:
    """The arrays ``dp_run`` reads: 4 cameras (the JAX test's
    ``make_camera``s), 60 Gaussian centres and the (4, 3, 24, 24) targets."""
    return dict(view=np.stack([np.asarray(c.view) for c in cams]),
                full_proj=np.stack([np.asarray(c.full_proj) for c in cams]),
                campos=np.stack([np.asarray(c.campos) for c in cams]),
                tan=np.array([cams[0].tan_fovx, cams[0].tan_fovy]),
                means=means, gts=gts)


def dp_run(mesh, inputs, densify: bool, steps: int = STEPS):
    """(trainer, losses) of the test's DP run: the tiny model of
    ``tests/test_parallel.py::_tiny_model`` (60 Gaussians at SH 0 in 128
    slots) on ``inputs``' 4 cameras at 24x24, 16x16 tiles."""
    from neuralgaussiansplatting_torch.models import gaussians as gm
    from neuralgaussiansplatting_torch.ops import preprocess as pp
    from neuralgaussiansplatting_torch.ops import rasterize as rast
    from neuralgaussiansplatting_torch.parallel.train_step import DPTrainer
    from neuralgaussiansplatting_torch.train import optim

    model = gm.GaussianModel(sh_degree=0, device="cpu")
    model.params, model.state = gm.create_from_pcd(
        inputs["means"], np.random.default_rng(7).random((60, 3)),
        np.zeros((60, 3)), 0, capacity=128, device="cpu")
    opt = optim.OptimizationParams(
        densify_from_iter=20 if densify else 10_000,
        densification_interval=40, opacity_reset_interval=10_000,
        densify_until_iter=10_000)
    settings = rast.RasterizeSettings(capacity=1 << 14, max_per_tile=256,
                                      chunk=16, block_x=16, block_y=16,
                                      backend="xla")
    trainer = DPTrainer(model, mesh, opt=opt, settings=settings,
                        batch_size=4, cameras_extent=1.0, seed=5,
                        auto_tune_capacity=False)
    tan_x, tan_y = inputs["tan"]
    cams = [pp.CameraParams(v, f, c, tan_x, tan_y, 24, 24, device="cpu")
            for v, f, c in zip(inputs["view"], inputs["full_proj"],
                               inputs["campos"])]
    gts = torch.from_numpy(inputs["gts"])
    losses = [trainer.step(cams, gts)["loss"].item() for _ in range(steps)]
    trainer.sync_model()
    return trainer, losses


def checksum(trainer) -> float:
    return float(sum(t.double().sum() for t in trainer.ts.params))


def main():
    rank, world, init_file, out = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    import torch.distributed as dist
    from neuralgaussiansplatting_torch.parallel import distributed

    distributed.initialize(init_method=f"file://{init_file}",
                           world_size=world, rank=rank, device="cpu")
    mesh = distributed.make_global_mesh(device="cpu")
    assert mesh.shape == {"data": world, "tile": 1}
    inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    trainer, losses = dp_run(mesh, inputs, densify=False)
    if rank == 0:
        np.savez(os.path.join(out, "world2.npz"), losses=np.asarray(losses),
                 xyz=trainer.ts.params.xyz.numpy())
    print(f"WORKER rank={rank} run=plain checksum={checksum(trainer)!r}",
          flush=True)
    trainer, _ = dp_run(mesh, inputs, densify=True)
    distributed.assert_synchronized(int(trainer.ts.gstate.alive.sum()))
    trainer.save_checkpoint(os.path.join(out, "dp2.ckpt"), STEPS * 4)
    print(f"WORKER rank={rank} run=densify checksum={checksum(trainer)!r} "
          f"alive={int(trainer.ts.gstate.alive.sum())}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
