"""The port's render entry point vs the root ``render.py``, on one model
directory that the port's train entry point writes (32x32 Blender scene,
the scan-oracle backend "xla", 10 iterations; the JAX ``render.py`` reads
the port's ``cfg_args``). Each side renders a copy of it with the same
backend: the same file names, every PNG within 1 level of 255. This file
holds the default "seq" backend (K1's plain version on the port's side),
``test_torch_render_entry_pallas.py`` the "pallas" one (K4's), so that
each file's JAX compiles stay near 20 s.

The JAX render is jitted (the root ``render.py`` calls it eagerly, which
costs ~25 s of op compiles per run here); jitted XLA fuses some products
and moves the image by float rounding only.
"""

import importlib.util
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu import gaussian_renderer as jgr
from neuralgaussiansplatting_tpu.scene import ply as jply
from neuralgaussiansplatting_torch import render as trender
from neuralgaussiansplatting_torch.ops import blend_pallas, blend_seq
from neuralgaussiansplatting_torch.scene.image_io import read_png
from neuralgaussiansplatting_torch.train import __main__ as train_entry

from test_scene import _make_blender_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 10


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("render_entry")
    src = str(tmp / "scene")
    _make_blender_scene(src, n_frames=6, size=32)
    rng = np.random.default_rng(0)
    jply.store_point_cloud(os.path.join(src, "points3d.ply"),
                           rng.normal(size=(200, 3)) * 0.8,
                           rng.random((200, 3)))
    model = str(tmp / "model")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NGS_PLATFORM", "cpu")
        train_entry.main(["-s", src, "-m", model, "--eval", "--iterations",
                          str(ITERS), "--save_iterations", str(ITERS),
                          "--test_iterations", str(ITERS),
                          "--model_capacity", "512", "--capacity", "8192",
                          "--backend", "xla", "--disable_viewer", "--quiet"])
    return model


def _root_render():
    spec = importlib.util.spec_from_file_location(
        "root_render", os.path.join(REPO, "render.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _counted(calls, key, fn):
    def wrapper(*args, **kw):
        calls[key] += 1
        return fn(*args, **kw)
    return wrapper


def _pngs(model):
    out = {}
    for split in ("train", "test"):
        for kind in ("renders", "gt"):
            d = os.path.join(model, split, f"ours_{ITERS}", kind)
            for name in sorted(os.listdir(d)):
                out[f"{split}/{kind}/{name}"] = read_png(os.path.join(d, name))
    return out


def assert_render_entry_matches_jax(model_dir, backend, tmp_path,
                                    monkeypatch):
    """Both ``render.py``s on copies of the same model: the same files
    (6 train and 6 test views, renders and GT), every PNG within 1 level;
    the ground truth equal. The port renders through K1's plain version
    ("seq") or K4's ("pallas"), once per view."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(model_dir, jdir)
    shutil.copytree(model_dir, tdir)

    monkeypatch.setattr(jgr, "render", jax.jit(jgr.render,
                                               static_argnums=(3, 5)))
    monkeypatch.setattr(sys, "argv", ["render.py", "-m", jdir, "--backend",
                                      backend])
    _root_render().main()

    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    calls = {"seq": 0, "pallas": 0}
    for key, module, name in (
            ("seq", blend_seq, "blend_tiles_seq_reference"),
            ("pallas", blend_pallas, "blend_tiles_pallas_reference")):
        monkeypatch.setattr(module, name, _counted(calls, key,
                                                   getattr(module, name)))
    summary = trender.main(["-m", tdir, "--backend", backend])
    assert calls == {"seq": 12 if backend == "seq" else 0,
                     "pallas": 12 if backend == "pallas" else 0}
    assert summary["iteration"] == ITERS and summary["dropped"] == 0
    assert {k: v["views"] for k, v in summary["splits"].items()} == {
        "train": 6, "test": 6}

    want, got = _pngs(jdir), _pngs(tdir)
    assert sorted(got) == sorted(want) and len(want) == 24
    differ = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape == (32, 32, 3), name
        diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
        assert diff.max() <= 1, (name, diff.max())
        if "/gt/" in name:
            np.testing.assert_array_equal(g, w, err_msg=name)
        differ += int((diff > 0).sum())
    share = differ / sum(w.size for w in want.values())
    print(f"{backend}: {share:.6f} of the PNG values differ by 1 level")


def test_render_entry_matches_jax(model_dir, tmp_path, monkeypatch):
    assert_render_entry_matches_jax(model_dir, "seq", tmp_path, monkeypatch)
