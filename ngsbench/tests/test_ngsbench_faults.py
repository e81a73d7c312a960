"""A run with the timed path broken underneath comes out not correct, and
a sound run comes out correct, at a small size on the CPU (the harness's
look for a card skipped; the port on its kernels' plain versions), held to
the real cells' limits. One run per fault the cells can have: a training
step that returns its state unchanged; half of the batch (the image's
rows) left out of the loss, the mean taken over the rest; an answer
altered where it is produced (a leaf's update doubled; a pixel of a
frame). There is no exchange between chips: every cell takes one."""

import time

import pytest
import torch

from ngsbench import harness
from ngsbench.tests import tiny


@pytest.fixture
def layout(tmp_path, monkeypatch):
    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    return tiny.layout(tmp_path)


def run(root, cell, seed=1234567890123):
    c = harness.resolve(root, cell)
    return harness.execute(c, seed, 0.3, False, torch.device("cpu"),
                           time.perf_counter(), lambda m: None)


def test_sound_runs_are_correct(layout):
    for cell in ("tiny.train", "tiny.render"):
        r = run(layout, cell)
        assert r["correct"], (cell, r["checks"])
        assert r["failed"] == 0 and r["attempted"] > 0
        assert list(r)[-1] == "checks"


def _patch_step(monkeypatch, change):
    from neuralgaussiansplatting_torch.train import loop
    real = loop.train_step

    def step(ts, *a, **kw):
        new, metrics = real(ts, *a, **kw)
        return change(ts, new), metrics

    monkeypatch.setattr(loop, "train_step", step)


def test_state_left_unchanged(layout, monkeypatch):
    _patch_step(monkeypatch, lambda old, new: old)
    r = run(layout, "tiny.train")
    assert not r["correct"]
    assert r["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(layout, monkeypatch):
    from neuralgaussiansplatting_torch.train import loop
    real = loop.losses.photometric_loss

    def half(pred, gt, lam=0.2):
        h = pred.shape[1] // 2
        return real(pred[:, :h], gt[:, :h], lam)

    monkeypatch.setattr(loop.losses, "photometric_loss", half)
    r = run(layout, "tiny.train")
    assert not r["correct"], r["checks"]


def test_an_update_moved_double(layout, monkeypatch):
    def double(old, new):
        op = 2 * new.params.opacity - old.params.opacity
        return new._replace(params=new.params._replace(opacity=op))

    _patch_step(monkeypatch, double)
    r = run(layout, "tiny.train")
    assert not r["correct"], r["checks"]


def test_a_pixel_altered(layout, monkeypatch):
    from neuralgaussiansplatting_torch import gaussian_renderer
    real = gaussian_renderer.render

    def render(*a, **kw):
        out = real(*a, **kw)
        img = out["render"].clone()
        img[1, 20, 30] += 0.1
        return dict(out, render=img)

    monkeypatch.setattr(gaussian_renderer, "render", render)
    r = run(layout, "tiny.render")
    assert not r["correct"], r["checks"]
