"""Training on the pallas path: one ``train_step`` at 16x16 tiles with chunk
8, port vs the JAX package, and the starved-capacity ``Trainer``.

The step is held at tests/test_torch_train.py's gates
(``torch_parity.assert_train_step_matches_jax``). The Trainer case is
tests/test_train.py::test_training_survives_sustained_overflow on the port:
a tiny instance buffer and per-tile cap drop instances on every step, and
30 steps must stay finite with the overflow monitor firing.
"""

import numpy as np
import torch

from neuralgaussiansplatting_tpu.ops import rasterize as jrast
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.ops import rasterize as trast
from neuralgaussiansplatting_torch.train import loop as tloop

from scenes import make_camera, random_gaussians
from torch_parity import (assert_train_step_matches_jax, port_camera,
                          train_step_inputs)

torch.set_num_threads(2)

FLAGS = dict(block_x=16, block_y=16, chunk=8, capacity=1 << 13,
             max_per_tile=1024, fast_sort=True, tight_culling=True,
             precise_cull=True)


def test_train_step_on_the_pallas_path_matches_jax():
    settings = trast.make_settings("pallas", **FLAGS)
    assert trast.blend_route(settings) == "pallas"
    assert_train_step_matches_jax(train_step_inputs(300, 320, settings),
                                  jrast.make_settings("pallas", **FLAGS),
                                  settings)


def test_training_survives_sustained_overflow():
    cam = port_camera(make_camera(W=48, H=48))
    means, *_ = random_gaussians(n=120, deg=0, seed=11)
    model = tgm.GaussianModel(sh_degree=0, device="cpu")
    model.params, model.state = tgm.create_from_pcd(
        means, np.random.default_rng(11).random((120, 3)),
        np.zeros((120, 3)), 0, capacity=128, device="cpu")
    # deliberately starved: tiny instance buffer + per-tile cap
    settings = trast.RasterizeSettings(
        capacity=1 << 9, max_per_tile=24, chunk=8, backend="pallas",
        tight_culling=True, precise_cull=True)
    trainer = tloop.Trainer(gaussians=model, settings=settings,
                            auto_grow=False, auto_tune_capacity=False)
    gt = torch.from_numpy(np.random.default_rng(12).random(
        (3, 48, 48)).astype(np.float32))
    dropped_seen = 0
    for it in range(1, 31):
        m = trainer.step(cam, gt, it)
        assert np.isfinite(float(m["loss"])), f"NaN loss at iter {it}"
        dropped_seen = max(dropped_seen, int(m["dropped"]))
        assert int(m["num_rendered"]) > 0
    assert dropped_seen > 0, "stress config failed to overflow"
    for name, leaf in zip(trainer.ts.params._fields, trainer.ts.params):
        assert torch.isfinite(leaf).all(), name
