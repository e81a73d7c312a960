"""The port's quality harnesses (``neuralgaussiansplatting_torch/tools/``:
``exp_quality_oracle``, ``train_quality_proof``, ``train_neural_quality``,
``train_garden``, ``bench_trained_scene``) against the JAX tools of
``tools/``.

- ``build_gt_params`` bit-equal to the JAX tool's but for the opacity
  logits, within 1 ulp: XLA's float32 ``log`` on the CPU is not correctly
  rounded (1 ulp off on ~12 % of these inputs; PyTorch's agrees with a
  float64 ``log`` on all but 15 of 39,996). The oracle's
  ``evaluate`` within 1e-4 dB of the JAX tool's on the same 32x32 scene
  (scan-oracle renders, "xla", on both sides).
- The JAX tools' ``main`` with ``subprocess`` replaced by a recorder (the
  train entry point's evaluation lines are fed back to them): the port's
  entry-point arguments equal the JAX tools' CLI arguments (the port adds
  only ``--disable_viewer``), and their milestones the JAX tools' for
  several ``--iters``; every harness's flag defaults equal the JAX tool's
  (the scene and output directories aside: the port's default under
  ``$TMPDIR``). The JAX oracle's ``run`` with a recording trainer gives
  its milestones.

Each harness's ``main`` runs on the CPU in
``tests/test_torch_quality_runs.py``.
"""

import json
import os
import random
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.ops import rasterize as jrast
from neuralgaussiansplatting_tpu.scene.scene import Scene as JScene
from neuralgaussiansplatting_tpu.train import loop as jloop
from neuralgaussiansplatting_tpu.train import optim as joptim
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.ops import rasterize as trast
from neuralgaussiansplatting_torch.scene.scene import Scene as TScene
from neuralgaussiansplatting_torch.tools import bench_trained_scene as tbench
from neuralgaussiansplatting_torch.tools import exp_quality_oracle as toracle
from neuralgaussiansplatting_torch.tools import make_demo_scene
from neuralgaussiansplatting_torch.tools import train_garden as tgarden
from neuralgaussiansplatting_torch.tools import train_neural_quality as tneural
from neuralgaussiansplatting_torch.tools import train_quality_proof as tproof
from neuralgaussiansplatting_torch.train import loop as tloop
from neuralgaussiansplatting_torch.train import optim as toptim

# two of the JAX tools set a compilation-cache directory in the environment
# when imported; keep the test process's environment as it was
_saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
from tools import bench_trained_scene as jbench  # noqa: E402
from tools import exp_quality_oracle as joracle  # noqa: E402
from tools import train_garden as jgarden  # noqa: E402
from tools import train_neural_quality as jneural  # noqa: E402
from tools import train_quality_proof as jproof  # noqa: E402

if _saved is None:
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)

torch.set_num_threads(2)

GT = 400
SCENE_ARGS = ["--size", "32", "--views", "6", "--init_points", "100"]


def eval_lines(cmd) -> str:
    """The train entry point's test-evaluation lines for a CLI command."""
    args = cmd[cmd.index("--test_iterations") + 1:]
    its = [a for a in args[:next((i for i, a in enumerate(args)
                                  if a.startswith("--")), len(args))]]
    n = int(cmd[cmd.index("--iterations") + 1])
    return "\n".join(f"[ITER {m}] Evaluating test: L1 0.01000 PSNR 30.00"
                     for m in its if int(m) <= n)


def jax_cli(tool, argv, monkeypatch):
    """Run JAX ``tool.main`` with ``argv`` and a recording ``subprocess``;
    returns (the train/trainn CLI command after the script, JSON written
    or None)."""
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, eval_lines(cmd), "")

    monkeypatch.setattr(tool.subprocess, "run", run)
    monkeypatch.setattr(tool.subprocess, "check_call",
                        lambda cmd, **kw: pytest.fail("scene generation"))
    monkeypatch.setattr(sys, "argv", [tool.__file__] + argv)
    tool.main()
    (cmd,) = seen
    return cmd[2:]


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


def test_build_gt_params_is_bit_equal_to_jax():
    jp, js = joracle.build_gt_params(3, 1 << 17)
    tp, ts = toracle.build_gt_params(3, 1 << 17, device="cpu")
    want_p, want_s = tgm.params_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()},
        {k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    for name in tgm.GaussianParams._fields:
        if name != "opacity":
            assert torch.equal(getattr(tp, name), getattr(want_p, name)), name
    ulps = (tp.opacity.view(torch.int32).long()
            - want_p.opacity.view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 1
    for name in tgm.GaussianState._fields:
        assert torch.equal(getattr(ts, name), getattr(want_s, name)), name


def test_evaluate_matches_jax(scene, monkeypatch):
    """Both packages' Scene, Trainer and the tool's ``evaluate`` on the
    scene's init cloud, scan-oracle renders (JAX's jitted: eager JAX spends
    ~20 s here compiling op by op)."""
    from neuralgaussiansplatting_tpu import gaussian_renderer as jgr
    monkeypatch.setattr(jgr, "render", jax.jit(jgr.render,
                                               static_argnums=(3, 5)))
    flags = dict(capacity=8192, max_per_tile=256)
    random.seed(0)
    jg = jgm.GaussianModel(sh_degree=3)
    js = JScene(scene, "", jg, eval_split=True)
    jt = jloop.Trainer(gaussians=jg, opt=joptim.OptimizationParams(),
                       settings=jrast.make_settings("xla", **flags),
                       cameras_extent=js.cameras_extent)
    random.seed(0)
    tg = tgm.GaussianModel(sh_degree=3, device="cpu")
    ts = TScene(scene, "", tg, eval_split=True)
    tt = tloop.Trainer(gaussians=tg, opt=toptim.OptimizationParams(),
                       settings=trast.make_settings("xla", **flags),
                       cameras_extent=ts.cameras_extent)
    for g in (jg, tg):
        g.active_sh_degree = 3
    want = joracle.evaluate(jt, js.get_test_cameras(), jt.settings)
    got = toracle.evaluate(tt, ts.get_test_cameras(), tt.settings)
    assert 5.0 < got < 60.0
    assert abs(got - want) <= 1e-4


@pytest.mark.parametrize("iters", [20, 600, 3000, 7000, 9000])
def test_proof_arguments_and_milestones_match_jax(iters, scene, tmp_path,
                                                  monkeypatch):
    argv = ["--scene", scene, "--out", str(tmp_path), "--iters", str(iters),
            "--fast_sort"]
    cmd = jax_cli(jproof, argv, monkeypatch)
    args = tproof.build_parser().parse_args(argv)
    assert tproof.entry_args(args) == cmd + ["--disable_viewer"]
    with open(tmp_path / "quality_proof.json") as f:
        rows = json.load(f)["test_psnr"]
    assert ([r["iteration"] for r in rows]
            == [m for m in tproof.milestones(iters) if m <= iters])


@pytest.mark.parametrize("iters", [4, 300, 1000, 3000, 8000])
def test_neural_arguments_and_milestones_match_jax(iters, tmp_path,
                                                   monkeypatch):
    argv = ["--scene", "s", "--out", str(tmp_path), "--iters", str(iters),
            "--start_ply", "p.ply", "--feature_lr", "0.001",
            "--mixed_precision", "--sw", "3"]
    cmd = jax_cli(jneural, argv, monkeypatch)
    args = tneural.build_parser().parse_args(argv)
    assert tneural.entry_args(args) == cmd
    with open(tmp_path / "neural_quality.json") as f:
        rows = json.load(f)["milestones"]
    assert ([r["iteration"] for r in rows]
            == [m for m in tneural.milestones(iters) if m <= iters])


@pytest.mark.parametrize("iters", [10, 500, 2000, 5000])
def test_garden_arguments_and_milestones_match_jax(iters, scene, tmp_path,
                                                   monkeypatch):
    argv = ["--scene", scene, "--out", str(tmp_path), "--iters", str(iters),
            "--model_capacity", "4096", "--steps_per_call", "2"]
    cmd = jax_cli(jgarden, argv, monkeypatch)
    args = tgarden.build_parser().parse_args(argv)
    assert tgarden.entry_args(args) == cmd + ["--disable_viewer"]
    with open(tmp_path / "garden_quality.json") as f:
        rows = json.load(f)["milestones"]
    assert ([r["iteration"] for r in rows]
            == [m for m in tgarden.milestones(iters) if m <= iters])


def test_harness_defaults_match_jax():
    for jtool, ttool in [(jproof, tproof), (jneural, tneural),
                         (jgarden, tgarden), (jbench, tbench),
                         (joracle, toracle)]:
        with pytest.MonkeyPatch.context() as mp:
            captured = {}
            real = jtool.ArgumentParser.parse_args

            def grab(self, *a, **kw):
                captured.update(vars(real(self, ["-m", "x"]
                                          if jtool is jbench else [])))
                raise SystemExit(0)

            mp.setattr(jtool.ArgumentParser, "parse_args", grab)
            with pytest.raises(SystemExit):
                jtool.main()
        want = {k: v for k, v in captured.items()
                if k not in ("scene", "out")}
        got = vars(ttool.build_parser().parse_args(
            ["-m", "x"] if jtool is jbench else []))
        assert {k: got[k] for k in want} == want, jtool.__name__
        assert set(got) == set(captured), jtool.__name__


class RecordingTrainer:
    """Stands in for the JAX ``Trainer`` in the JAX oracle's ``run``."""

    def __init__(self, gaussians, **kw):
        self.ts = types.SimpleNamespace(
            gstate=types.SimpleNamespace(alive=jnp.ones(3, bool)))
        self.settings = kw["settings"]
        self.auto_grow = True

    def grad_step(self, cam, gt, it):
        return {"loss": 0.0}

    def apply_schedule(self, it, m):
        return m


@pytest.mark.parametrize("iters", [20, 200, 1500, 6000])
def test_oracle_milestones_match_jax(iters, scene, monkeypatch):
    from neuralgaussiansplatting_tpu.scene import scene as jscene
    monkeypatch.setattr(jloop, "Trainer", RecordingTrainer)
    monkeypatch.setattr(joracle, "evaluate", lambda *a, **kw: 0.0)
    # the JAX tool's model directory is a fixed path: write none
    monkeypatch.setattr(jscene, "Scene",
                        lambda src, model, g, **kw: JScene(src, "", g, **kw))
    rows = joracle.run("cloudinit", scene, iters)
    assert [r["iteration"] for r in rows] == toracle.milestones(iters)
