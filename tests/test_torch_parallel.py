"""Data and strip parallelism, port vs the JAX package: ``strip_cameras``,
``render_strips``, the data-parallel step's statistics, ``DPTrainer``, the
``distributed`` helpers, a two-process gloo world against one process, and
the train entry point's ``--data_parallel`` under ``torchrun``.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's multi-process runs start their processes here, each with one
thread, a ``file://`` store under the test's directory (or torchrun's
standalone rendezvous on a free port) and a timeout.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.ops import rasterize as jrast
from neuralgaussiansplatting_tpu.parallel import mesh as jmesh
from neuralgaussiansplatting_tpu.parallel import render_sp as jsp
from neuralgaussiansplatting_tpu.parallel import train_step as jpts
from neuralgaussiansplatting_tpu.train import optim as joptim
from neuralgaussiansplatting_torch.gaussian_renderer import render as trender
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.ops import rasterize as trast
from neuralgaussiansplatting_torch.parallel import distributed
from neuralgaussiansplatting_torch.parallel import mesh as tmesh
from neuralgaussiansplatting_torch.parallel import render_sp as tsp
from neuralgaussiansplatting_torch.parallel import train_step as tpts
from neuralgaussiansplatting_torch.train import densify as tdens
from neuralgaussiansplatting_torch.train import optim as toptim
from neuralgaussiansplatting_torch.utils import losses as tlosses

from scenes import make_camera, random_gaussians
from test_torch_multistep import _scene_dir
from torch_dp_worker import STEPS, dp_inputs, dp_run
from torch_parity import port_camera, to_torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_parallel.py's settings: 16x16 tiles, the scan oracle
FLAGS = dict(capacity=1 << 14, max_per_tile=256, chunk=16, block_x=16,
             block_y=16, backend="xla")
J_SETTINGS = jrast.RasterizeSettings(**FLAGS)
T_SETTINGS = trast.RasterizeSettings(**FLAGS)
WORKER_ENV = dict(os.environ, OMP_NUM_THREADS="1", NGS_PLATFORM="cpu")


def _models(n, deg, seed, capacity):
    """(JAX params, state), (port params, state) of the same cloud."""
    means, scales, rot, opac, shs = random_gaussians(n=n, deg=deg, seed=seed)
    params, state = jgm.create_from_pcd(
        means, np.random.default_rng(seed).random((n, 3)),
        np.zeros((n, 3)), deg, capacity=capacity)
    params = params._replace(
        scaling=params.scaling.at[:n].set(jnp.asarray(np.log(scales))),
        rotation=params.rotation.at[:n].set(jnp.asarray(rot)),
        opacity=params.opacity.at[:n].set(
            jnp.asarray(np.log(opac / (1 - opac))[:, None])))
    port = tgm.params_from_numpy(
        jgm.GaussianParams(*map(np.asarray, params)),
        jgm.GaussianState(*map(np.asarray, state)), device="cpu")
    return (params, state), port


def test_strip_cameras_match_jax():
    """The float32 projection rows, tan_fovy, size and the carried
    frustum-clamp limits equal JAX's, strip by strip."""
    cam = make_camera(W=48, H=64)
    want = jsp.strip_cameras(cam, 4)
    got = tsp.strip_cameras(port_camera(cam), 4)
    np.testing.assert_array_equal(got.full_proj.numpy(),
                                  np.asarray(want.full_proj))
    np.testing.assert_array_equal(got.view.numpy(), np.asarray(want.view))
    np.testing.assert_array_equal(got.campos.numpy(),
                                  np.asarray(want.campos))
    assert (got.tan_fovx, got.tan_fovy, got.width, got.height,
            got.limit_x, got.limit_y) == (
        want.tan_fovx, want.tan_fovy, want.width, want.height,
        want.limit_x, want.limit_y)
    one = got.camera(2)
    assert one.view.shape == (4, 4) and one.height == 16
    with pytest.raises(ValueError, match="strips"):
        tsp.strip_cameras(port_camera(cam), 5)


def test_render_strips_match_jax_and_monolithic():
    """Four 16-row strips of a 48x64 frame: the port's ``render_strips``
    within JAX's atol 1e-5 of JAX's ``render_strips`` and of the port's
    own monolithic render, the strips' instances adding up to the frame's,
    and ``make_sharded_renderer`` on a 1 x 1 mesh giving the same image."""
    cam = make_camera(W=48, H=64)
    (jp, js), (tp, ts) = _models(150, 1, 0, 150)
    bg = np.asarray([0.2, 0.3, 0.4], np.float32)
    want = jax.jit(jsp.render_strips, static_argnums=(3, 5))(
        jsp.strip_cameras(cam, 4), jp, js.alive, 1, jnp.asarray(bg),
        J_SETTINGS)
    tcam = port_camera(cam)
    strips = tsp.strip_cameras(tcam, 4)
    with torch.no_grad():
        got = tsp.render_strips(strips, tp, ts.alive, 1, to_torch(bg),
                                T_SETTINGS)
        whole = trender(tcam, tp, ts.alive, 1, to_torch(bg), T_SETTINGS)
        parts = [int(trender(strips.camera(i), tp, ts.alive, 1,
                             to_torch(bg), T_SETTINGS)["num_rendered"])
                 for i in range(4)]
        sharded = tsp.make_sharded_renderer(
            tmesh.make_mesh(device="cpu"), sh_degree=1, settings=T_SETTINGS,
            n_strips=4)(tcam, tp, ts.alive, to_torch(bg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), whole["render"].numpy(),
                               atol=1e-5)
    assert sum(parts) == int(whole["num_rendered"])
    assert torch.equal(sharded, got)
    with pytest.raises(ValueError, match="tiles"):
        tsp.render_strips(tsp.strip_cameras(tcam, 8), tp, ts.alive, 1,
                          to_torch(bg), T_SETTINGS)


def test_dp_batched_stats_match_sequential():
    """One data-parallel step over 3 cameras (one process) has the
    statistics of 3 single-camera iterations: denom and max radii exact,
    the accumulator at JAX's rtol 1e-4 / atol 1e-7
    (``tests/test_parallel.py:97-166``)."""
    cams = [port_camera(make_camera(W=24, H=24, angle=a))
            for a in (0.0, 1.1, 2.2)]
    _, (tp, ts) = _models(60, 0, 3, 64)
    gt = torch.zeros((3, 24, 24))
    seq = ts
    for cam in cams:
        off = torch.zeros((64, 2), requires_grad=True)
        out = trender(cam, tp, ts.alive, 0, torch.zeros(3), T_SETTINGS,
                      means2d_offset=off)
        goff, = torch.autograd.grad(
            tlosses.photometric_loss(out["render"], gt, 0.2), [off])
        seq = tdens.add_densification_stats(seq, out["radii"], goff)
    tx = toptim.make_optimizer(toptim.OptimizationParams(), 1.0)
    step = tpts.make_dp_train_step(tmesh.make_mesh(device="cpu"), tx,
                                   sh_degree=0, settings=T_SETTINGS)
    got, metrics = step(tpts.TrainState(tp, ts, tx.init(tp), 0),
                        tpts.stack_cameras(cams), gt.expand(3, 3, 24, 24),
                        torch.zeros(3))
    assert torch.equal(got.gstate.denom, seq.denom)
    assert got.gstate.denom.max() == 3
    assert torch.equal(got.gstate.max_radii2d, seq.max_radii2d)
    np.testing.assert_allclose(got.gstate.xyz_gradient_accum.numpy(),
                               seq.xyz_gradient_accum.numpy(), rtol=1e-4,
                               atol=1e-7)
    assert got.step == 1 and np.isfinite(metrics["loss"].item())


@pytest.fixture(scope="module")
def dp_case(tmp_path_factory):
    """The two-process test's inputs (``torch_dp_worker.dp_inputs``) and
    the one-process run of them."""
    out = tmp_path_factory.mktemp("dp")
    cams = [make_camera(W=24, H=24, angle=a) for a in np.linspace(0, 2.8, 4)]
    means, *_ = random_gaussians(n=60, deg=0, seed=7)
    gts = np.random.default_rng(5).random((4, 3, 24, 24)).astype(np.float32)
    inputs = dp_inputs(cams, means, gts)
    np.savez(out / "inputs.npz", **inputs)
    trainer, losses = dp_run(tmesh.make_mesh(device="cpu"), inputs,
                             densify=False)
    return dict(out=out, cams=cams, means=means, gts=gts, inputs=inputs,
                trainer=trainer, losses=losses)


def test_dp_trainer_matches_jax_on_one_device(dp_case):
    """The port's ``DPTrainer`` (one process) against JAX's on a one-device
    mesh, batch 4, densification off, at the gate JAX holds its own DP
    trainer to across device counts (``tests/test_parallel.py:169-182``):
    losses at rtol 2e-4 / atol 2e-5, positions at rtol 1e-4 / atol 1e-5;
    denom equal."""
    mesh = jmesh.make_mesh(n_data=1, n_tile=1)
    g = jgm.GaussianModel(sh_degree=0)
    g.params, g.state = jgm.create_from_pcd(
        dp_case["means"], np.random.default_rng(7).random((60, 3)),
        np.zeros((60, 3)), 0, capacity=128)
    jt = jpts.DPTrainer(g, mesh, opt=joptim.OptimizationParams(
        densify_from_iter=10_000, densification_interval=40,
        opacity_reset_interval=10_000, densify_until_iter=10_000),
        settings=J_SETTINGS, batch_size=4, cameras_extent=1.0, seed=5,
        auto_tune_capacity=False)
    gts = jnp.asarray(dp_case["gts"])
    jl = [float(jt.step(dp_case["cams"], gts)["loss"]) for _ in range(STEPS)]
    tt = dp_case["trainer"]
    np.testing.assert_allclose(dp_case["losses"], jl, rtol=2e-4, atol=2e-5)
    assert tt._camera_iter == jt._camera_iter == 4 * STEPS
    np.testing.assert_allclose(tt.ts.params.xyz.numpy(),
                               np.asarray(jt.ts.params.xyz), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(tt.ts.gstate.denom.numpy(),
                                  np.asarray(jt.ts.gstate.denom))


def test_two_gloo_processes_match_one(dp_case, tmp_path):
    """Two gloo processes, 2 cameras each, against the one-process run of
    the same batch of 4: losses at rtol 2e-4 / atol 2e-5, positions at
    rtol 1e-4 / atol 1e-5 (JAX's ``tests/test_parallel.py:169-182``;
    densification off, as there). With densification on, both ranks end
    equal and rank 0 alone writes the checkpoint."""
    out = dp_case["out"]
    init = str(tmp_path / "store")
    worker = os.path.join(REPO, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), "2", init, str(out)], env=WORKER_ENV,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, f"{stdout[-2000:]}\n{stderr[-3000:]}"
            outs.append(stdout)
    finally:
        for p in procs:
            p.kill()
    lines = {}
    for text in outs:
        for line in text.splitlines():
            if line.startswith("WORKER "):
                fields = dict(f.split("=") for f in line.split()[1:])
                lines[fields["rank"], fields["run"]] = fields
    assert len(lines) == 4, outs
    for run in ("plain", "densify"):
        assert lines["0", run]["checksum"] == lines["1", run]["checksum"]
    world2 = np.load(out / "world2.npz")
    np.testing.assert_allclose(world2["losses"], dp_case["losses"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(world2["xyz"],
                               dp_case["trainer"].ts.params.xyz.numpy(),
                               rtol=1e-4, atol=1e-5)
    ckpt = torch.load(out / "dp2.ckpt", weights_only=True)
    assert ckpt["iteration"] == 4 * STEPS
    assert int(ckpt["gstate"]["alive"].sum()) == int(
        lines["0", "densify"]["alive"])


def test_dp_checkpoint_round_trip(dp_case, tmp_path):
    """``save_checkpoint`` -> ``restore_checkpoint`` into a fresh
    ``DPTrainer``: the same tensors and camera counter, and the next step
    of both bit-equal."""
    tt = dp_case["trainer"]
    path = str(tmp_path / "dp.ckpt")
    tt.save_checkpoint(path, 4 * STEPS)
    fresh, _ = dp_run(tmesh.make_mesh(device="cpu"), dp_case["inputs"],
                      densify=False, steps=0)
    assert fresh.restore_checkpoint(path) == 4 * STEPS
    assert fresh._camera_iter == tt._camera_iter
    for a, b in zip(list(tt.ts.params) + list(tt.ts.gstate),
                    list(fresh.ts.params) + list(fresh.ts.gstate)):
        assert torch.equal(a, b)
    inputs = dp_case["inputs"]
    cams = [tpts.CameraParams(v, f, c, *inputs["tan"], 24, 24, device="cpu")
            for v, f, c in zip(inputs["view"], inputs["full_proj"],
                               inputs["campos"])]
    gts = torch.from_numpy(inputs["gts"])
    before = tt.ts, tt._camera_iter
    m_a = tt.step(cams, gts)
    after = tt.ts
    tt.ts, tt._camera_iter = before      # the fixture's trainer, unchanged
    m_b = fresh.step(cams, gts)
    assert torch.equal(m_a["loss"], m_b["loss"])
    for a, b in zip(after.params, fresh.ts.params):
        assert torch.equal(a, b)


def test_distributed_helpers_single_process():
    """One process, no group (``tests/test_viewer_and_utils.py:145-154``):
    ``initialize`` is a no-op, the global mesh is 1 x 1, the batch slice
    is the whole batch, a broadcast returns its value and the
    synchronisation guard passes."""
    assert distributed.initialize(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    mesh = distributed.make_global_mesh(n_tile=1, device="cpu")
    assert mesh.shape == {"data": 1, "tile": 1}
    assert mesh.data_group is None and mesh.tile_group is None
    assert distributed.process_local_batch_slice(16) == (0, 16)
    assert distributed.host_broadcast_pytree({"a": 1}) == {"a": 1}
    distributed.assert_synchronized(42)
    with pytest.raises(ValueError):
        distributed.make_global_mesh(n_tile=2, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        tmesh.batch_sharded(tmesh.make_mesh(device="cpu"), 3) and \
            tmesh.batch_sharded(tmesh.Mesh(2, 1, torch.device("cpu")), 3)


def test_entry_point_data_parallel_two_processes(tmp_path):
    """``torchrun --standalone --nproc_per_node 2 -m
    neuralgaussiansplatting_torch.train --data_parallel 2`` on the CPU
    (gloo): 8 cameras in 4 steps, rank 0 alone evaluating and writing the
    model, checkpoint and config files."""
    src = _scene_dir(str(tmp_path / "scene"))
    model = str(tmp_path / "model")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "neuralgaussiansplatting_torch.train",
         "-s", src, "-m", model, "--eval", "--iterations", "8",
         "--test_iterations", "8", "--save_iterations", "8",
         "--checkpoint_iterations", "4", "--model_capacity", "512",
         "--capacity", "8192", "--data_parallel", "2", "--disable_viewer"],
        cwd=REPO, env=WORKER_ENV, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}"
    assert r.stdout.count("[ITER 8] Evaluating test") == 1, r.stdout
    assert r.stdout.count("Training complete.") == 1
    for name in ("point_cloud/iteration_8/point_cloud.ply", "chkpnt4.ckpt",
                 "cfg_args", "cameras.json", "input.ply"):
        assert os.path.exists(os.path.join(model, name)), name
    ckpt = torch.load(os.path.join(model, "chkpnt4.ckpt"), weights_only=True)
    assert ckpt["iteration"] == 4
    params, _, _ = tgm.load_ply(os.path.join(
        model, "point_cloud", "iteration_8", "point_cloud.ply"), device="cpu")
    assert all(torch.isfinite(t).all() for t in params)


def test_bench_scaling_tool_on_cpu_processes():
    """The port's ``tools/bench_scaling`` on gloo CPU processes (world
    sizes 1 and 2, one step each): a row per world size, flagged
    correctness-grade, with world 1's efficiency 1."""
    from neuralgaussiansplatting_torch.tools import bench_scaling
    out = bench_scaling.main(["--device", "cpu", "--worlds", "1", "2",
                              "--iters", "1", "--n", "300", "--size", "32"])
    assert out["correctness_grade_only"]
    assert [r["world"] for r in out["rows"]] == [1, 2]
    assert out["rows"][0]["scaling_efficiency"] == 1.0
    assert all(r["step_ms"] > 0 for r in out["rows"])
