"""The port's offline tools and their utils vs the JAX package:
``utils/image`` (metrics, the BGR conversion, the grid), ``utils/
feature_analysis`` (text outputs byte-equal, plots under the same names),
LPIPS with synthetic VGG weights, ``metrics`` on a renders tree written by
the port, and ``full_eval``'s command sequences.
"""

import csv
import importlib.util
import json
import os
import runpy
import shlex
import sys

import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.utils import feature_analysis as jfa
from neuralgaussiansplatting_tpu.utils import image as jimage
from neuralgaussiansplatting_tpu.utils import lpips as jlpips
from neuralgaussiansplatting_torch import full_eval as tfull_eval
from neuralgaussiansplatting_torch import metrics as tmetrics
from neuralgaussiansplatting_torch.scene.image_io import write_png
from neuralgaussiansplatting_torch.utils import feature_analysis as tfa
from neuralgaussiansplatting_torch.utils import image as timage
from neuralgaussiansplatting_torch.utils import lpips as tlpips

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def root_cli(name):
    """The root ``<name>.py`` CLI of the JAX package, imported as a module
    (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(REPO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _image(kind, seed):
    rng = np.random.default_rng(seed)
    shape = {"chw_float3": (3, 8, 10), "hwc_float3": (8, 10, 3),
             "chw_uint8_3": (3, 8, 10), "hwc_uint8_1": (8, 10, 1),
             "chw_float1": (1, 8, 10), "hw_float": (8, 10),
             "chw_float_out_of_range": (3, 8, 10)}[kind]
    if "uint8" in kind:
        return rng.integers(0, 256, shape).astype(np.uint8)
    if "out_of_range" in kind:
        return (rng.normal(size=shape) * 2).astype(np.float32)
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["chw_float3", "hwc_float3", "chw_uint8_3",
                                  "hwc_uint8_1", "chw_float1", "hw_float",
                                  "chw_float_out_of_range"])
def test_image_utils_match_jax(kind):
    """mse, psnr (inf on equal images), the BGR uint8 conversion and the
    grid (square and two-column) equal to the JAX package's."""
    a, b = _image(kind, 0), _image(kind, 1)
    assert timage.mse(a, b) == jimage.mse(a, b)
    assert timage.psnr(a, b) == jimage.psnr(a, b)
    assert timage.psnr(a, a) == jimage.psnr(a, a) == float("inf")
    np.testing.assert_array_equal(timage._to_bgr_u8(a), jimage._to_bgr_u8(a))
    for cols in (None, 2):
        np.testing.assert_array_equal(timage.make_grid([a, b, a], cols),
                                      jimage.make_grid([a, b, a], cols))


def test_windows_are_no_ops_headless(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("NGS_FORCE_GUI", raising=False)
    img = _image("chw_float3", 0)
    assert timage._gui_available() is False
    assert timage.show_img(img) is False
    assert timage.show_img2(img, img) is False
    assert timage.show_img_grid([img, img]) is False


def _analyses(fa, root, feats):
    fa.analyze_gaussian_features(feats, 5, root)
    fa.analyze_gaussian_features(feats * 2, 10, root)
    fa.plot_feature_distributions(feats, 5, root)
    fa.plot_density(feats, 5, root)
    fa.plot_64d_analysis(feats, 5, root)
    fa.plot_history_trends(root)
    return os.path.join(root, "feature_analysis")


def test_feature_analysis_matches_jax(tmp_path):
    """The same features at two iterations: the stats reports, the CSV
    history and the 64-d detailed stats byte-equal to the JAX package's,
    and every plot written under the same name."""
    feats = np.random.default_rng(0).normal(size=(120, 64)).astype(np.float32)
    feats[:7, :5] = 0.0
    jdir = _analyses(jfa, str(tmp_path / "jax"), feats)
    tdir = _analyses(tfa, str(tmp_path / "port"), feats)
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    assert {"history.csv", "stats_iter_5.txt", "stats_iter_10.txt",
            "trends.png", "64d_feature_analysis_iter_5.png"} <= set(names)
    for name in names:
        if not name.endswith(".png"):
            with open(os.path.join(jdir, name), "rb") as f:
                want = f.read()
            with open(os.path.join(tdir, name), "rb") as f:
                assert f.read() == want, name
    with open(os.path.join(tdir, "history.csv")) as f:
        assert [r["iteration"] for r in csv.DictReader(f)] == ["5", "10"]


def test_plots_need_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib the plots raise ImportError, as the JAX
    package's do, and the statistics are still written."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    feats = np.ones((4, 64), np.float32)
    assert os.path.exists(tfa.analyze_gaussian_features(feats, 1,
                                                        str(tmp_path)))
    for plot in (tfa.plot_feature_distributions, tfa.plot_density,
                 tfa.plot_64d_analysis):
        with pytest.raises(ImportError):
            plot(feats, 1, str(tmp_path))


@pytest.fixture
def lpips_weights(tmp_path, monkeypatch):
    """Seeded VGG16 weights in the JAX package's schema (HWIO convolutions,
    per-channel lin vectors), named by ``NGS_LPIPS_WEIGHTS``."""
    rng = np.random.default_rng(0)
    out = {}
    cin = 3
    li = 0
    for c, n_convs in jlpips.VGG16_STAGES:
        for _ in range(n_convs):
            out[f"conv{li}_w"] = rng.normal(
                scale=0.05, size=(3, 3, cin, c)).astype(np.float32)
            out[f"conv{li}_b"] = rng.normal(scale=0.01,
                                            size=c).astype(np.float32)
            cin = c
            li += 1
    for i, (c, _) in enumerate(jlpips.VGG16_STAGES):
        out[f"lin{i}_w"] = rng.random(c).astype(np.float32) / c
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **out)
    monkeypatch.setenv("NGS_LPIPS_WEIGHTS", path)
    jlpips._load_params.cache_clear()
    tlpips._load_params.cache_clear()
    yield path
    jlpips._load_params.cache_clear()
    tlpips._load_params.cache_clear()


@pytest.mark.parametrize("hw", [(32, 32), (40, 56)])
def test_lpips_matches_jax(lpips_weights, hw):
    """``lpips_pair`` with the weights carried HWIO -> OIHW equals the
    JAX package's LPIPS to rtol 1e-5; an image against itself is 0."""
    rng = np.random.default_rng(hw[1])
    a = rng.random((3,) + hw).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(
        np.float32)
    jfn = jlpips.lpips_fn("vgg")
    want = jfn(a, b)
    params = tlpips.torch_params(tlpips._load_params("vgg"), "cpu")
    assert params["conv0_w"].shape == (64, 3, 3, 3)
    got = float(tlpips.lpips_pair(params, torch.from_numpy(a),
                                  torch.from_numpy(b)))
    assert got == pytest.approx(want, rel=1e-5)
    tfn = tlpips.lpips_fn("vgg", device="cpu")
    assert tfn(a, b) == pytest.approx(want, rel=1e-5)
    assert tfn(a, a) == pytest.approx(0.0, abs=1e-6)
    assert jfn(a, a) == pytest.approx(0.0, abs=1e-6)


@pytest.fixture
def no_lpips_weights(tmp_path, monkeypatch):
    """``NGS_LPIPS_WEIGHTS`` naming a file that does not exist."""
    monkeypatch.setenv("NGS_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    jlpips._load_params.cache_clear()
    tlpips._load_params.cache_clear()
    yield None
    jlpips._load_params.cache_clear()
    tlpips._load_params.cache_clear()


def test_lpips_fn_is_none_without_weights(no_lpips_weights):
    assert jlpips.lpips_fn("vgg") is None
    assert tlpips.lpips_fn("vgg", device="cpu") is None
    assert tlpips.default_weights_path() == os.path.join(
        REPO, "weights", "lpips_vgg.npz")


def _renders_tree(model):
    """Two methods of three 32x32 test views, written by the port's PNG
    encoder (one RGBA render, whose alpha the metrics drop)."""
    rng = np.random.default_rng(4)
    for method in ("ours_10", "ours_20"):
        for kind in ("renders", "gt"):
            os.makedirs(os.path.join(model, "test", method, kind))
        for i in range(3):
            gt = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
            noise = rng.integers(-40, 41, gt.shape)
            render = np.clip(gt + noise, 0, 255).astype(np.uint8)
            if i == 1:
                render = np.concatenate(
                    [render, np.full((32, 32, 1), 200, np.uint8)], axis=2)
            write_png(os.path.join(model, "test", method, "renders",
                                   f"{i:05d}.png"), render)
            write_png(os.path.join(model, "test", method, "gt",
                                   f"{i:05d}.png"), gt)


def _read_json(model):
    with open(os.path.join(model, "results.json")) as f:
        results = json.load(f)
    with open(os.path.join(model, "per_view.json")) as f:
        return results, json.load(f)


def _assert_scores_close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_scores_close(got[key], want[key])
    elif isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            _assert_scores_close(g, w)
    elif want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("weights", ["lpips_weights", "no_lpips_weights"])
def test_metrics_match_jax(tmp_path, monkeypatch, request, weights):
    """The JAX package's ``metrics.evaluate`` and the port's on the same
    renders tree: the same files and keys, SSIM, PSNR and LPIPS (synthetic
    weights) to rtol 1e-5; LPIPS null on both sides without weights."""
    with_lpips = request.getfixturevalue(weights) is not None
    model = str(tmp_path / "model")
    _renders_tree(model)
    want = root_cli("metrics").evaluate([model])
    want_files = _read_json(model)
    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    got = tmetrics.main(["-m", model])
    got_files = _read_json(model)
    _assert_scores_close(got, want)
    _assert_scores_close(got_files, want_files)
    lpips = got[model]["ours_20"]["LPIPS"]
    assert (lpips is not None and np.isfinite(lpips)) == with_lpips
    assert sorted(got_files[1]["ours_10"]["PSNR"]) == [
        "00000.png", "00001.png", "00002.png"]


@pytest.mark.parametrize("argv", [
    ["-m360", "a", "-tat", "b", "-db", "c"],
    ["--skip_training", "-tat", "b", "--output_path", "out"],
    ["-db", "c", "-m360", "m", "--skip_rendering", "--skip_metrics"],
    ["--skip_metrics"],
])
def test_full_eval_commands_match_jax(argv, monkeypatch):
    """The root ``full_eval.py`` (``os.system`` recorded) and the port's
    (``run`` recorded) issue the same commands in the same order, the root
    CLIs mapped to the port's entry points."""
    recorded = []
    monkeypatch.setattr(os, "system",
                        lambda cmd: recorded.append(shlex.split(cmd)) or 0)
    monkeypatch.setattr(sys, "argv", ["full_eval.py"] + argv)
    runpy.run_path(os.path.join(REPO, "full_eval.py"), run_name="__main__")
    mapping = {f"{name}.py": tfull_eval.entry(name)
               for name in ("train", "render", "metrics")}
    want = [mapping[cmd[1]] + cmd[2:] for cmd in recorded
            if cmd[0] == "python"]
    assert len(want) == len(recorded)

    issued = []
    monkeypatch.setattr(tfull_eval, "run",
                        lambda cmd: issued.append(cmd) or 0)
    summary = tfull_eval.main(argv)
    assert issued == summary["commands"] == want
    assert summary["returncodes"] == [0] * len(want)
    if argv == ["-m360", "a", "-tat", "b", "-db", "c"]:
        # 13 scenes trained, each rendered at 7000 and 30000, one metrics
        assert len(want) == 13 + 26 + 1
