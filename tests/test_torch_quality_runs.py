"""The port's quality harnesses (``neuralgaussiansplatting_torch/tools/``)
run as a user runs them, on the CPU (``NGS_PLATFORM=cpu``): each one's
``main`` on a demo scene the port's tool writes (32x32, 6 views, 400
ground-truth Gaussians), writing its JSON with the JAX tool's keys and
milestone rows. The argument, milestone and parity checks against the JAX
tools are in ``tests/test_torch_quality_tools.py``.

The train entry point is given 8192-instance buffers (its 2^20 default
costs seconds per iteration in the kernels' plain versions here), the
oracle the same buffers and this scene's 400-Gaussian mixture in place of
the 40k one, which its ``hold`` then reads back at the generator's own
PSNR. ``bench_trained_scene`` is held to the JAX tool's ``main`` on the
same model, that one's render and timer stood in by the port's probe
demand, for its keys and buffer sizing.
"""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_torch.tools import bench_trained_scene as tbench
from neuralgaussiansplatting_torch.tools import exp_quality_oracle as toracle
from neuralgaussiansplatting_torch.tools import make_demo_scene
from neuralgaussiansplatting_torch.tools import train_garden as tgarden
from neuralgaussiansplatting_torch.tools import train_neural_quality as tneural
from neuralgaussiansplatting_torch.tools import train_quality_proof as tproof
from neuralgaussiansplatting_torch.train import __main__ as train_entry

# the JAX bench sets a compilation-cache directory in the environment when
# imported; keep the test process's environment as it was
_saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
from tools import bench_trained_scene as jbench  # noqa: E402
from tools import chain_bench as jchain  # noqa: E402

if _saved is None:
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)

torch.set_num_threads(2)

GT = 400
SCENE_ARGS = ["--size", "32", "--views", "6", "--init_points", "100"]
ENTRY_BUFFERS = ["--capacity", "8192"]
ITERS = 20
NEURAL_ITERS = 4
HOLD_PSNR = 40.0   # dB: the uint8 PNGs of a render of the same mixture


@pytest.fixture(scope="module")
def cpu_platform():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NGS_PLATFORM", "cpu")
        yield


@pytest.fixture(scope="module")
def scene(tmp_path_factory, cpu_platform):
    root = str(tmp_path_factory.mktemp("quality") / "scene")
    make_demo_scene.main(["--out", root, "--n_gaussians", str(GT),
                          *SCENE_ARGS, "--device", "cpu"])
    return root


@pytest.fixture
def small_entry(monkeypatch):
    """The train entry point with CPU-sized instance buffers."""
    real = train_entry.main
    monkeypatch.setattr(train_entry, "main",
                        lambda argv: real(argv + ENTRY_BUFFERS + ["--quiet"]))


@pytest.fixture(scope="module")
def proof(scene, tmp_path_factory, cpu_platform):
    out = str(tmp_path_factory.mktemp("proof"))
    real = train_entry.main
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_entry, "main",
                   lambda argv: real(argv + ENTRY_BUFFERS + ["--quiet"]))
        result = tproof.main(["--scene", scene, "--out", out,
                              "--iters", str(ITERS)])
    return out, result


def test_quality_proof_main_on_cpu(proof):
    out, result = proof
    with open(os.path.join(out, "quality_proof.json")) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(result))
    assert {"dataset", "schedule", "fast_sort", "iterations",
            "wall_clock_s", "test_psnr"} <= set(written)
    assert [r["iteration"] for r in written["test_psnr"]] == [ITERS]
    assert set(written["test_psnr"][0]) == {"iteration", "l1", "psnr"}
    assert 10.0 < written["test_psnr"][0]["psnr"] < 60.0
    assert written["alive"] <= written["capacity"]
    assert written["launches"] == {}          # the CPU runs plain versions
    assert written["device"] == "cpu"
    assert os.path.exists(os.path.join(out, "point_cloud",
                                       f"iteration_{ITERS}",
                                       "point_cloud.ply"))


def test_oracle_main_on_cpu(scene, monkeypatch, cpu_platform):
    """``hold`` at the scene's own mixture reads it back; ``gtcloud``
    starts from its points."""
    monkeypatch.setattr(toracle, "GT_GAUSSIANS", GT)
    monkeypatch.setattr(toracle, "GT_CAPACITY", 1024)
    monkeypatch.setattr(toracle, "SETTINGS",
                        dict(toracle.SETTINGS, capacity=8192))
    hold = toracle.main(["hold", "--scene", scene, "--iters", str(ITERS)])
    rows = hold["hold"]
    assert [r["iteration"] for r in rows] == [0, ITERS]
    assert set(rows[1]) == {"iteration", "psnr", "alive", "loss",
                            "elapsed_s"}
    assert rows[0]["psnr"] >= HOLD_PSNR and rows[1]["psnr"] >= HOLD_PSNR
    assert rows[0]["alive"] == 396            # 33 per cluster of 12
    cloud = toracle.main(["gtcloud", "--scene", scene, "--iters", "2"])
    assert cloud["gtcloud"][0]["alive"] == 396
    assert cloud["gtcloud"][0]["psnr"] < rows[0]["psnr"]


def test_neural_main_on_cpu(proof, scene, tmp_path, cpu_platform):
    out, _ = proof
    ply = os.path.join(out, "point_cloud", f"iteration_{ITERS}",
                       "point_cloud.ply")
    result = tneural.main(["--scene", scene, "--out", str(tmp_path),
                           "--iters", str(NEURAL_ITERS), "--start_ply", ply])
    with open(tmp_path / "neural_quality.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(result))
    assert {"sw", "iterations", "start_ply", "milestones",
            "wall_clock_s"} <= set(written)
    rows = written["milestones"]
    assert [r["iteration"] for r in rows] == [2, 4]
    assert all(np.isfinite(r["psnr"]) for r in rows)


def test_garden_main_on_cpu(tmp_path, small_entry, cpu_platform):
    scene = str(tmp_path / "scene")
    result = tgarden.main([
        "--scene", scene, "--out", str(tmp_path / "out"), "--iters", "10",
        "--width", "48", "--height", "32", "--views", "4",
        "--gt_gaussians", str(GT), "--init_points", "300",
        "--model_capacity", "1024", "--steps_per_call", "5"])
    with open(tmp_path / "out" / "garden_quality.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(result))
    assert {"scene", "iterations", "model_capacity", "milestones",
            "wall_clock_s", "iters_per_s", "final_alive_line"} <= set(written)
    assert written["scene"]["resolution"] == "48x32"
    assert [r["iteration"] for r in written["milestones"]] == [5, 10]
    assert written["final_alive_line"] == "alive 300 of capacity 1024"
    assert np.isfinite(written["last_loss"])
    assert [it for it, _ in written["tune_drops"]] == []


def test_bench_trained_scene_matches_jax(proof, monkeypatch, capsys,
                                         cpu_platform):
    """The port's bench on the proof's model at 64x48 (its probe's buffers
    cut to 8192 instances for the CPU); the JAX bench's
    ``main`` on the same files with its render and timer stood in by the
    port's probe demand, for its keys and buffer sizing."""
    out, _ = proof
    monkeypatch.setattr(tbench, "PROBE",
                        dataclasses.replace(tbench.PROBE, capacity=8192))
    got = tbench.main(["-m", out, "--width", "64", "--height", "48"])
    assert got["n_alive"] > 0 and got["dropped"] == 0
    assert got["fwd_ms"] > 0 and got["fwdbwd_ms"] > 0

    def fake_render(cam, params, alive, sh, bg, settings):
        return {"num_rendered": jnp.int32(got["num_rendered"]),
                "aligned_demand": jnp.int32(got["aligned_demand"]),
                "culled": jnp.int32(got["culled"]),
                "render": jnp.zeros((3, 48, 64))}

    from neuralgaussiansplatting_tpu import gaussian_renderer as jgr
    monkeypatch.setattr(jgr, "render", fake_render)
    monkeypatch.setattr(jchain, "chain", lambda *a, **kw: 2.0)
    monkeypatch.setattr(sys, "argv", ["bench", "-m", out, "--width", "64",
                                      "--height", "48"])
    capsys.readouterr()
    jbench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(want) <= set(got)
    for key in ("model", "n_alive", "resolution", "capacity",
                "packed_capacity"):
        assert got[key] == want[key], key
