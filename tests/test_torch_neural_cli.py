"""``python -m neuralgaussiansplatting_torch.trainn`` as a user runs it, on
the CPU (``NGS_PLATFORM=cpu``), at 32x32 for 4 iterations, with its
geometry from a run of the port's train entry point: its checkpoint (also
re-padded by a larger ``--model_capacity``) or its saved PLY, for ``--sw``
2 and 3. Each run writes the files ``tests/test_cli.py``'s
``test_trainn_cli`` checks for the root ``trainn.py``, and its saved
geometry is the source's, bit for bit, while the features trained. Also
the entry point in process without matplotlib. The PLY runs are in
``test_torch_neural_cli_ply.py`` (a subprocess here costs ~10 s).
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.scene import ply as jply
from neuralgaussiansplatting_torch import trainn as ttrainn
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.train import __main__ as train_entry

from test_scene import _make_blender_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSIC_ITERS = 10
GEOMETRY = ("xyz", "normals", "features_dc", "features_rest", "scaling",
            "rotation", "opacity")


@pytest.fixture(scope="module")
def classic(tmp_path_factory):
    """(scene, model) of a 10-iteration run of the port's train entry
    point with a checkpoint at its end."""
    tmp = tmp_path_factory.mktemp("neural_cli")
    src = str(tmp / "scene")
    _make_blender_scene(src, n_frames=4, size=32)
    rng = np.random.default_rng(1)
    jply.store_point_cloud(os.path.join(src, "points3d.ply"),
                           rng.normal(size=(150, 3)) * 0.8,
                           rng.random((150, 3)))
    model = str(tmp / "classic")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NGS_PLATFORM", "cpu")
        train_entry.main(["-s", src, "-m", model, "--iterations",
                          str(CLASSIC_ITERS), "--save_iterations",
                          str(CLASSIC_ITERS), "--checkpoint_iterations",
                          str(CLASSIC_ITERS), "--test_iterations", "-1",
                          "--model_capacity", "256", "--capacity", "8192",
                          "--disable_viewer", "--quiet"])
    return src, model


def _source_geometry(model, source):
    """The alive rows of the source model's parameters."""
    if source == "ply":
        params, _, _ = tgm.load_ply(os.path.join(
            model, "point_cloud", f"iteration_{CLASSIC_ITERS}",
            "point_cloud.ply"), device="cpu")
        return params
    ckpt = torch.load(os.path.join(model, f"chkpnt{CLASSIC_ITERS}.ckpt"),
                      weights_only=True)
    params = tgm.normalize_params(tgm.GaussianParams(**ckpt["params"]))
    alive = ckpt["gstate"]["alive"]
    return tgm.GaussianParams(*(a[alive] for a in params))


def run_trainn_cli(classic, sw, source, tmp_path):
    """One subprocess run of the entry point from ``source`` ("checkpoint",
    "checkpoint_capacity" or "ply") and its checks."""
    src, model = classic
    out = str(tmp_path / "neural")
    ckpt = os.path.join(model, f"chkpnt{CLASSIC_ITERS}.ckpt")
    flags = {"checkpoint": ["--start_checkpoint", ckpt],
             "ply": ["--start_ply", os.path.join(
                 model, "point_cloud", f"iteration_{CLASSIC_ITERS}",
                 "point_cloud.ply")]}
    extra = flags[source.split("_")[0]]
    if source == "checkpoint_capacity":
        extra = extra + ["--model_capacity", "512"]
    env = dict(os.environ, NGS_PLATFORM="cpu", OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "neuralgaussiansplatting_torch.trainn",
         "-s", src, "-m", out, "--sw", str(sw), "--iterations", "4",
         "--save_iterations", "4", "--video_interval", "0",
         "--analysis_interval", "2"] + extra,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (f"STDOUT:{r.stdout[-2000:]}\n"
                               f"STDERR:{r.stderr[-3000:]}")
    said = ("restored from" if source.startswith("checkpoint")
            else "loaded from")
    assert f"Geometry {said}" in r.stdout
    if source == "checkpoint_capacity":
        assert "capacity 512)" in r.stdout
    ply = os.path.join(out, "point_cloud", "iteration_4", "point_cloud.ply")
    for name in (ply, "cfg_args", "cameras.json", "input.ply",
                 os.path.join("feature_analysis", "history.csv"),
                 os.path.join("feature_analysis", "stats_iter_4.txt")):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "feature_analysis", "history.csv")) as f:
        assert [row["iteration"] for row in csv.DictReader(f)] == ["2", "4"]

    want = _source_geometry(model, source)
    got, _, _ = tgm.load_ply(ply, device="cpu")
    for field in GEOMETRY:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert got.features.shape == want.features.shape
    assert not torch.equal(got.features, want.features)


@pytest.mark.parametrize("sw,source", [(2, "checkpoint"),
                                       (3, "checkpoint_capacity")])
def test_trainn_cli(classic, sw, source, tmp_path):
    run_trainn_cli(classic, sw, source, tmp_path)


def test_trainn_skips_plots_without_matplotlib(classic, tmp_path,
                                               monkeypatch, capsys):
    """Without matplotlib the entry point says the plots are skipped,
    writes the statistics and ``history.csv`` and no plot, and trains on."""
    src, model = classic
    out = str(tmp_path / "neural")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    summary = ttrainn.main(["-s", src, "-m", out, "--sw", "1",
                            "--iterations", "2", "--analysis_interval", "1",
                            "--video_interval", "0", "--test_iterations",
                            "2", "--start_checkpoint", os.path.join(
                                model, f"chkpnt{CLASSIC_ITERS}.ckpt")])
    assert summary["plots"] is False
    assert "feature plots are skipped" in capsys.readouterr().out
    names = os.listdir(os.path.join(out, "feature_analysis"))
    assert sorted(names) == ["history.csv", "stats_iter_1.txt",
                             "stats_iter_2.txt"]
    assert np.isfinite(summary["last_loss"])
    l1, psnr = summary["evals"][2]["train"]
    assert np.isfinite(l1) and np.isfinite(psnr)
