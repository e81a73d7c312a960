"""The reference's per-pixel pair counts against a brute-force count, and
the operation and byte arithmetic of ``counts.py``."""

import numpy as np
import torch

from ngsbench import counts, scene
from ngsbench.reference import render as ref
from ngsbench.tests import tiny


def brute_force(scr: ref.Screen, width: int, height: int, tile: int):
    """Pixel by pixel in float32 numpy: the Gaussians of the pixel's tile
    (those whose 3-sigma square, of the screen's radius, touches it) in
    depth order, under the reference's rules; pads the image to whole tiles
    as the blend does."""
    tx, ty = -(-width // tile), -(-height // tile)
    m = scr.means2d.numpy()
    con = scr.conic.numpy()
    op = scr.opacity.numpy()
    r = scr.radius.numpy().astype(np.float32)
    drawn = r > 0
    rect = np.stack([
        np.clip(np.floor((m[:, 0] - r) / tile), 0, tx),
        np.clip(np.floor((m[:, 1] - r) / tile), 0, ty),
        np.clip(np.floor((m[:, 0] + r + tile - 1) / tile), 0, tx),
        np.clip(np.floor((m[:, 1] + r + tile - 1) / tile), 0, ty)], 1)
    order = np.argsort(scr.depth.numpy(), kind="stable")
    fwd = blended = 0
    inst = set()
    for py in range(ty * tile):
        for px in range(tx * tile):
            t = (px // tile, py // tile)
            T = np.float32(1.0)
            for g in order:
                r = rect[g]
                if not (drawn[g] and r[0] <= t[0] < r[2]
                        and r[1] <= t[1] < r[3]):
                    continue
                dx = np.float32(m[g, 0] - np.float32(px))
                dy = np.float32(m[g, 1] - np.float32(py))
                power = (np.float32(-0.5) * (con[g, 0] * dx * dx
                                             + con[g, 2] * dy * dy)
                         - con[g, 1] * dx * dy)
                a = min(np.float32(0.99), op[g] * np.exp(min(power, 0)))
                if power > 0 or a < np.float32(1 / 255):
                    continue
                fwd += 1
                inst.add((g, t))
                if T * (1 - a) < 1e-4:
                    break
                blended += 1
                T = T * (1 - a)
    return fwd, blended, len(inst), len({g for g, _ in inst})


def test_pair_counts_against_brute_force():
    cfg = tiny.config()
    cfg.update(n_gaussians=150, width=40, height=36)
    cloud = scene.make_cloud(cfg, 5, "cpu")
    cloud["opacity"] = cloud["opacity"] + 5.0      # some pixels saturate
    cam = scene.cameras(cfg, "orbit")[1]
    img, scr, _, c = ref.render(cloud, cam, 3, torch.zeros(3), 16,
                                counts=True, pair_budget=1 << 12, sub=4)
    fwd, blended, inst, needed = brute_force(scr, 40, 36, 16)
    # evaluating a Gaussian on the whole of its tiles gives the same image
    whole = ref.render(cloud, cam, 3, torch.zeros(3), 16, sub=16)[0]
    assert torch.equal(img, whole)
    assert blended > 0 and fwd > blended
    assert (c["fwd_pairs"], c["blended"], c["instances"],
            c["gaussians_needed"]) == (fwd, blended, inst, needed)
    assert c["pixels"] == 40 * 36
    assert c["drawn"] == int((scr.radius > 0).sum())


def test_operation_and_byte_counts():
    c = {"fwd_pairs": 1000, "blended": 600, "instances": 50, "pixels": 64,
         "drawn": 20, "gaussians_needed": 18}
    assert counts.k1_ops(c) == 1000 * 16 + 600 * 10
    assert counts.k2_ops(c) == 600 * 60
    assert counts.k1_bytes(c, 4) == 50 * 36 + 64 * 20 + 4 * 8
    assert counts.k2_bytes(c, 4) == 2 * 50 * 36 + 64 * 36 + 4 * 8
    t, bound = counts.k1_least_s(c, 4)
    assert bound == "bytes" and t == counts.k1_bytes(c, 4) / 3.35e12
    big = dict(c, fwd_pairs=10 ** 12, blended=10 ** 11)
    t, bound = counts.k1_least_s(big, 4)
    assert bound == "operations" and t == counts.k1_ops(big) / 67e12
    render = counts.step_ops(c, "render")
    assert render == 20 * (222 + 149) + counts.k1_ops(c)
    train = counts.step_ops(c, "train", trainable=123 * 20)
    assert train == render + 2 * 20 * 371 + counts.k2_ops(c) \
        + 3 * 64 * 502 + 123 * 20 * 14
