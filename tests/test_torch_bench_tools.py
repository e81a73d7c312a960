"""The port's bench tools (``bench``, ``tools.bench_suite``,
``tools.bench_garden``) against the JAX package's, on the CPU.

Each JAX tool's ``main`` runs in process with its scene builder stood in by
the same seeded scene of 2000 Gaussians at 64x48 (at 800x800 for
``bench.py``, whose render is stood in) and its timer by a stub; the
port's tool runs with ``NGS_PLATFORM=cpu`` on the same scene, its chained
timer stubbed the same way (the garden and suite stubs run each chain body
once). Everything that is not a time is held equal: the scenes asked for,
the settings of every mode, the probe monitors, ``capacity`` /
``packed_capacity``, the chained depths, metric names, units and JSON
keys (the port's extra keys are each tool's ``EXTRA_KEYS``). The probes'
capacities are cut to 2^15 on both sides for the CPU; the sizing rules
take the probe's demand, which is far below that here.
"""

import ast
import dataclasses
import io
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from neuralgaussiansplatting_tpu import gaussian_renderer as jgr
from neuralgaussiansplatting_tpu.ops import rasterize as jrast
from neuralgaussiansplatting_tpu.utils import losses as jlosses
from neuralgaussiansplatting_torch import bench as tbench
from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch.tools import bench_garden as tgarden
from neuralgaussiansplatting_torch.tools import bench_suite as tsuite

# the JAX tools set a compilation-cache directory in the environment when
# imported; keep the test process's environment as it was
_saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
import bench as jbench  # noqa: E402
from tools import bench_garden as jgarden  # noqa: E402
from tools import bench_suite as jsuite  # noqa: E402

if _saved is None:
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)

torch.set_num_threads(2)

JAX_SCENE = __graft_entry__._demo_scene
N, W, H = 2000, 64, 48
PROBE_CAP = 1 << 15
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("NGS_PLATFORM", "cpu")


def scene_kwargs(kw: dict) -> dict:
    """A scene request's workload: n, size, SH degree and seed."""
    return {"seed": 0, **{k: v for k, v in kw.items() if k != "device"}}


def small_scenes(monkeypatch, jax_owner, port_owner, size=(W, H)):
    """Stand both tools' scene builders in by the seeded small scene;
    returns the lists of (JAX, port) scene requests."""
    asked = ([], [])

    def jax_scene(**kw):
        asked[0].append(scene_kwargs(kw))
        return JAX_SCENE(**{**kw, "n": N, "w": size[0], "h": size[1]})

    def port_scene(**kw):
        asked[1].append(scene_kwargs(kw))
        return demo.demo_scene(**{**kw, "n": N, "w": size[0],
                                  "h": size[1]})

    monkeypatch.setattr(*jax_owner, jax_scene)
    monkeypatch.setattr(port_owner, "demo_scene", port_scene)
    return asked


def cut_probe(settings):
    """``settings`` with its capacities cut to ``PROBE_CAP``."""
    cut = dict(capacity=min(settings.capacity, PROBE_CAP))
    if settings.packed_capacity is not None:
        cut["packed_capacity"] = min(settings.packed_capacity, PROBE_CAP)
    return dataclasses.replace(settings, **cut)


def recording_jax_render(monkeypatch, owner, seen):
    """Stand ``owner.render`` in by the real JAX render at cut capacities,
    recording the settings it was asked for."""
    real = jgr.render

    def render(cam, p, alive, sh, bg, settings):
        seen.append(settings)
        return real(cam, p, alive, sh, bg, cut_probe(settings))

    monkeypatch.setattr(owner, "render", render)


def same_settings(port, jax_settings):
    """The port's settings hold every field of the JAX ones (the JAX
    package's ``grad_reduce`` at its default, which the port has no
    counterpart of)."""
    want = dataclasses.asdict(jax_settings)
    assert want.pop("grad_reduce") == "auto"
    assert dataclasses.asdict(port) == want


def stub_port_chain(monkeypatch, owner, depths, run_body=True):
    """The port's chained timer stood in: records (iters, reps), runs the
    body once on the first carry when ``run_body``, and says 500 ms."""
    def chain(make_body, x0, iters=8, reps=3):
        depths.append((iters, reps))
        if run_body:
            make_body()(x0, 0.0)
        return 500.0
    monkeypatch.setattr(owner, "chain", chain)


def json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_bench_matches_jax(monkeypatch, capsys, cpu_platform):
    """bench.py: its settings, scene, metric, unit, keys, and (with its
    clock stubbed to 9 s per 10-step run and 0 s per one-step run, the
    port's chain to 1 s per step) the same value and ratio, which
    holds only if both chain 10 steps."""
    asked = small_scenes(monkeypatch, (__graft_entry__, "_demo_scene"),
                         tbench, size=(800, 800))
    seen = []

    def render(cam, p, alive, sh, bg, settings):
        seen.append(settings)
        return {"render": jnp.zeros((3, 800, 800)) + 0.0 * p.xyz.sum()}

    monkeypatch.setattr(jgr, "render", render)
    # the stood-in render has nothing to compare: keep the loss cheap
    monkeypatch.setattr(jlosses, "photometric_loss",
                        lambda a, b, lam: jnp.mean(jnp.abs(a - b)))
    ticks = iter([0, 9, 10, 19, 20, 29, 30, 30, 40, 40, 50, 50])
    monkeypatch.setattr(jbench, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks)))
    jbench.main()
    want = json_lines(capsys.readouterr().out)[-1]

    depths = []

    def chain(make_body, x0, iters=8, reps=3):
        depths.append((iters, reps))
        return 1000.0
    monkeypatch.setattr(tbench, "chain", chain)
    got = tbench.main([])
    assert json_lines(capsys.readouterr().out)[-1] == got
    assert depths == [(10, 3)] and next(ticks, None) is None
    assert asked[0] == asked[1] == [
        {"seed": 0, "n": 100_000, "w": 800, "h": 800, "sh_degree": 3}]
    same_settings(tbench.SETTINGS, seen[0])
    assert set(got) == set(want) | set(tbench.EXTRA_KEYS)
    assert {k: got[k] for k in want} == want
    assert got["timing"] == "chained eager, host clock"
    assert got["device"] == "cpu" and got["launches"] == {}


def test_bench_suite_matches_jax(monkeypatch, capsys, cpu_platform,
                                 tmp_path):
    """tools/bench_suite.py: the four workloads' scenes and settings, the
    1080p probe's monitors and packed capacity, the chained depths, the
    records' names, units, keys and (the timers stubbed to 0.5 s per step)
    values, the probe's drops, and the neural z-buffer capacity; the port
    writes its records to ``--out`` only."""
    asked = small_scenes(monkeypatch, (__graft_entry__, "_demo_scene"),
                         tsuite)
    made = []
    real_make = jrast.make_settings

    def make_settings(*a, **kw):
        made.append(real_make(*a, **kw))
        return made[-1]

    monkeypatch.setattr(jrast, "make_settings", make_settings)
    recording_jax_render(monkeypatch, jgr, [])
    jax_depths = []

    def chain_time(make_step, x0, iters=8, reps=3):
        jax_depths.append((iters, reps))
        return 0.5

    monkeypatch.setattr(jsuite, "chain_time", chain_time)
    # the stood-in timer never runs the neural step: skip the Flax init
    monkeypatch.setattr(jgr, "init_decoders", lambda key: {})
    written = {}

    class Capture(io.StringIO):
        def close(self):
            written["text"] = self.getvalue()
            super().close()

    def fake_open(path, mode="r", *a, **kw):
        # the JAX tool writes its record at the repository root: keep it
        assert path == os.path.join(ROOT, "bench_suite_results.json")
        assert mode == "w"
        return Capture()

    monkeypatch.setattr(jsuite, "open", fake_open, raising=False)
    jsuite.main()
    want = json_lines(capsys.readouterr().out)
    assert json.loads(written["text"]) == [r for r in want
                                          if "value" in r]

    probe = tsuite.PROBE_1080
    monkeypatch.setattr(tsuite, "PROBE_1080", cut_probe(probe))
    depths = []
    stub_port_chain(monkeypatch, tsuite, depths)
    out = str(tmp_path / "suite.json")
    got_results = tsuite.main(["--out", out])
    got = json_lines(capsys.readouterr().out)
    with open(out) as f:
        assert json.load(f) == got_results
    assert [r for r in got if "value" in r] == got_results

    assert asked[0] == asked[1] == [
        {"seed": 0, "n": 10_000, "w": 256, "h": 256, "sh_degree": 0},
        {"seed": 0, "n": 100_000, "w": 800, "h": 800, "sh_degree": 3},
        {"seed": 0, "n": 100_000, "w": 1920, "h": 1080, "sh_degree": 3},
        {"seed": 0, "n": 100_000, "w": 800, "h": 800, "sh_degree": 1}]
    assert depths == jax_depths == [(8, 3), (8, 3), (8, 3), (6, 3)]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        extra = (tsuite.PROBE_EXTRA_KEYS if "value" not in w
                 else tsuite.EXTRA_KEYS)
        assert set(g) == set(w) | set(extra)
        assert {k: g[k] for k in w} == w
    probe_line = got[2]
    assert probe_line["metric"] == "1080p demand probe"
    assert probe_line["dropped"] == 0 and probe_line["num_rendered"] > 0
    kcap = probe_line["packed_capacity"]
    assert kcap == tsuite.size_from_probe(probe_line["aligned_demand"])
    monkeypatch.setattr(tsuite, "PROBE_1080", probe)
    for port, jax_settings in zip(
            (tsuite.CONFIG1, tsuite.CONFIG2, probe,
             tsuite.settings_1080(kcap)), made):
        same_settings(port, jax_settings)
    assert all(r["timing"] == "chained eager, host clock"
               for r in got_results)

    # the neural workload's z-buffer capacity, read from the JAX tool
    tree = ast.parse(open(jsuite.__file__).read())
    caps = [eval(compile(ast.Expression(k.value), "", "eval"))
            for node in ast.walk(tree) if isinstance(node, ast.Call)
            and getattr(node.func, "id", None) == "render2"
            for k in node.keywords if k.arg == "capacity"]
    assert caps == [tsuite.NEURAL_CAPACITY]


@pytest.mark.parametrize("args", [
    ["2000"], ["2000", "1"], ["2000", "--seqscatter"],
    ["2000", "--scatter", "--fwd-only"]],
    ids=["dense", "dense_cap1", "seqscatter", "scatter_fwd_only"])
def test_bench_garden_matches_jax(args, monkeypatch, capsys, cpu_platform):
    """tools/bench_garden.py in each mode: the cloud asked for (seed 3,
    the scales' shift), the probe and sized settings, the monitors (a
    dense cap of 1 clips instances, which both count as dropped), capacity
    and packed capacity, the chained depths and the JSON keys. The JAX tool
    prints its constant resolution; the port prints its camera's."""
    asked = small_scenes(monkeypatch, (jgarden, "_demo_scene"), tgarden)
    seen = []
    recording_jax_render(monkeypatch, jgarden, seen)
    jax_depths = []

    def chain(make_body, x0, iters=8, reps=3):
        jax_depths.append((iters, reps))
        return 10.0

    monkeypatch.setattr(jgarden, "chain", chain)
    monkeypatch.setattr(sys, "argv", ["bench_garden", *args])
    jgarden.main()
    want = json_lines(capsys.readouterr().out)[-1]

    real_probe = tgarden.probe_settings
    monkeypatch.setattr(tgarden, "probe_settings",
                        lambda mode, dc: cut_probe(real_probe(mode, dc)))
    depths = []
    stub_port_chain(monkeypatch, tgarden, depths)
    got = tgarden.main(args)
    assert json_lines(capsys.readouterr().out)[-1] == got

    assert asked[0] == asked[1] == [
        {"seed": 3, "n": 2000, "w": 1920, "h": 1080, "sh_degree": 3}]
    assert depths == jax_depths
    assert set(got) == set(want) | set(tgarden.EXTRA_KEYS)
    assert want.pop("resolution") == "1920x1080"
    assert got["resolution"] == f"{W}x{H}"
    timed = {"fwd_ms", "fwd_fps", "fwdbwd_ms", "fwdbwd_mpix_s"}
    assert {k: got[k] for k in want if k not in timed} == {
        k: v for k, v in want.items() if k not in timed}
    positional = [a for a in args if not a.startswith("-")]
    dense_cap = int(positional[1]) if len(positional) > 1 else 6
    # a dense cap of 1 clips every Gaussian that touches two tiles or more
    assert (got["monitors"]["dropped"] > 0) == (dense_cap == 1)

    mode = ("seqscatter" if "--seqscatter" in args
            else "scatter" if "--scatter" in args else "dense")
    probe = real_probe(mode, dense_cap)
    same_settings(probe, seen[0])
    same_settings(tgarden.sized_settings(mode, probe, got["capacity"],
                                         got["packed_capacity"]), seen[1])
    assert (got["capacity"], got["packed_capacity"]) == \
        tgarden.size_from_probe(got["monitors"]["num_rendered"],
                                got["monitors"]["aligned_demand"])
    assert got["timing"] == "chained eager, host clock"


def test_bench_garden_cloud_is_the_jax_cloud():
    """``garden_cloud`` builds the JAX tool's cloud: the demo cloud with
    seed 3 and its log-scales lowered by 2.2, at 1920x1080."""
    params, state, cam = tgarden.garden_cloud(300, device="cpu")
    jparams, _, jcam = JAX_SCENE(
        n=300, w=1920, h=1080, sh_degree=3, seed=3)
    assert torch.equal(params.scaling,
                       torch.tensor(np.asarray(jparams.scaling - 2.2)))
    assert torch.equal(params.xyz, torch.tensor(np.asarray(jparams.xyz)))
    assert (cam.width, cam.height) == (jcam.width, jcam.height)
