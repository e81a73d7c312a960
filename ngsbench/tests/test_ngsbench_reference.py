"""The plain reference against hand-worked pixels and against the port run
on the CPU (``NGS_PLATFORM=cpu``: its kernels' plain versions)."""

import math
import os

import pytest
import torch

from ngsbench import program, scene
from ngsbench.reference import render as ref
from ngsbench.reference import train as ref_train
from ngsbench.tests import tiny


def screen(gaussians, tile=32):
    """A Screen of hand-placed Gaussians, every one covering tile 0:
    (x, y, (a, b, c), opacity, rgb, depth)."""
    n = len(gaussians)
    f = torch.tensor
    return ref.Screen(
        means2d=f([[g[0], g[1]] for g in gaussians]),
        conic=f([list(g[2]) for g in gaussians]),
        opacity=f([g[3] for g in gaussians]),
        rgb=f([list(g[4]) for g in gaussians]),
        depth=f([g[5] for g in gaussians]),
        radius=torch.full((n,), 3, dtype=torch.long),
        rect=torch.tensor([[0, 0, 1, 1]] * n), unit=tile)


def pixel(gaussians, x, y, bg=(0.1, 0.2, 0.3)):
    scr = screen(gaussians)
    bins = ref.bin_tiles(scr, 32, 32, 32)
    out = ref.composite_block(scr, bins, torch.tensor([0]),
                              int(bins.count[0]), torch.tensor(bg))
    return out[0, y * 32 + x]


def test_one_gaussian_by_hand():
    rgb = (1.0, 0.5, 0.25)
    g = (5.0, 5.0, (1.0, 0.0, 1.0), 0.5, rgb, 1.0)
    bg = torch.tensor([0.1, 0.2, 0.3])
    # at the centre: alpha = opacity
    assert torch.allclose(pixel([g], 5, 5), 0.5 * torch.tensor(rgb)
                          + 0.5 * bg, atol=1e-6)
    # one pixel off: power -1/2
    a = 0.5 * math.exp(-0.5)
    assert torch.allclose(pixel([g], 6, 5), a * torch.tensor(rgb)
                          + (1 - a) * bg, atol=1e-6)
    # the cross term: power = -b dx dy for dx = dy = 1 with a = c = 0
    gb = (5.0, 5.0, (0.0, 0.5, 0.0), 0.5, rgb, 1.0)
    a = 0.5 * math.exp(-0.5)
    assert torch.allclose(pixel([gb], 6, 6), a * torch.tensor(rgb)
                          + (1 - a) * bg, atol=1e-6)
    # alpha clamped at 0.99
    g1 = (5.0, 5.0, (1.0, 0.0, 1.0), 1.0, rgb, 1.0)
    assert torch.allclose(pixel([g1], 5, 5), 0.99 * torch.tensor(rgb)
                          + 0.01 * bg, atol=1e-6)
    # under 1/255: skipped
    far = pixel([g], 5 + 4, 5)     # 0.5 exp(-8) < 1/255
    assert torch.allclose(far, bg)


def test_two_gaussians_by_hand():
    c1, c2 = (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)
    near = (4.0, 4.0, (1.0, 0.0, 1.0), 0.6, c1, 1.0)
    back = (4.0, 4.0, (1.0, 0.0, 1.0), 0.7, c2, 2.0)
    bg = torch.tensor([0.1, 0.2, 0.3])
    want = (0.6 * torch.tensor(c1) + 0.4 * 0.7 * torch.tensor(c2)
            + 0.4 * 0.3 * bg)
    # the order is by depth, not by index
    assert torch.allclose(pixel([back, near], 4, 4), want, atol=1e-6)


def test_stop_before_transmittance_under_1e4():
    c = [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)]
    con = (1.0, 0.0, 1.0)
    gs = [(3.0, 3.0, con, 0.99, c[0], 1.0), (3.0, 3.0, con, 0.98, c[1], 2.0),
          (3.0, 3.0, con, 0.9, c[2], 3.0)]
    bg = torch.tensor([0.1, 0.2, 0.3])
    # T after two is 0.01 * 0.02 = 2e-4 >= 1e-4; the third would leave
    # 2e-5 and is not blended; the background sees T = 2e-4
    want = (0.99 * torch.tensor(c[0]) + 0.01 * 0.98 * torch.tensor(c[1])
            + 2e-4 * bg)
    assert torch.allclose(pixel(gs, 3, 3), want, atol=1e-6)


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("NGS_PLATFORM", "cpu")


def test_reference_matches_port_on_cpu(cpu_platform):
    """Image, loss and the parameters after two training steps, the port
    (plain versions of K1/K2 on the CPU) against the reference, on the
    tiny configuration's inputs."""
    cfg = tiny.config()
    dev = torch.device("cpu")
    prog = program.Program()
    cams = scene.cameras(cfg, "train")
    ext = scene.extent(cams)
    gt = scene.make_images(cfg, 11, len(cams), dev)
    bg = program.background(cfg, dev)
    cloud = scene.make_cloud(cfg, 11, dev)
    model = prog.model(cfg, cloud, ext)
    settings = prog.sized_settings(cfg, model, [prog.camera(c, dev)
                                                for c in cams], bg,
                                   lambda m: None)
    # the image
    pcam = prog.camera(cams[0], dev)
    with torch.no_grad():
        img = prog.renderer.render(pcam, model.params, model.state.alive, 3,
                                   bg, settings)["render"]
    want = ref.render(cloud, cams[0], 3, bg, 32)[0]
    assert want.shape == (3, 46, 72) and float(want.max()) > 0.1
    assert (img - want).abs().max() < 2e-6
    # two steps
    trainer = prog.loop.Trainer(gaussians=model,
                                opt=prog.optim.OptimizationParams(),
                                settings=settings,
                                white_background=cfg["white_background"],
                                cameras_extent=ext)
    views = [2, 4]
    losses = [float(trainer.step(prog.camera(cams[v], dev), gt[v],
                                 15001 + i)["loss"])
              for i, v in enumerate(views)]
    r = ref_train.steps(cloud, [cams[v] for v in views],
                        [gt[v] for v in views], bg, 3, 32, ext)
    assert losses == pytest.approx(r["loss"], rel=1e-6)
    params = trainer.ts.params
    for k, v in r["params"].items():
        moved = (getattr(params, k) - cloud[k]).abs()
        gap = (getattr(params, k) - v).abs()
        # Adam's step is about the rate wherever a gradient is not nought,
        # so a gradient a rounding away from 0 can move an element by a
        # rate either way: the gap is held to 1e-3 of the largest move
        # but for a few elements
        assert float((gap > 1e-3 * float(moved.max())).float().mean()) < 0.01

