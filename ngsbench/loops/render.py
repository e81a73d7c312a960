"""Closed-loop viewing (a mix with ``"loop": "render"``).

One viewer: ``gaussian_renderer.render`` under ``no_grad`` of the
configuration's orbit views in order, looping, each frame synchronised
before the next is asked for. The window reports ``render_fps``, its
frames over its wall time, and ``render_p95_ms``, the 95th percentile of
every frame's latency from its call to its synchronisation. The check
compares ``checked_frames`` frames drawn from the seed in the window's
first pass and its last frame with the reference's renders of the same
views.

Mix keys: ``warmup_frames``, ``checked_frames``, ``trace_ops`` (frames in
the traced window), ``counted_frames`` (traced frames whose work the
reference counts for the rooflines).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ngsbench import check, program, scene, trace
from ngsbench.reference import render as ref_render

KIND = "render"
# the kernels whose records this loop's readers need: label -> name
KERNELS = {k: program.KERNEL_NAMES[k] for k in ("K1",)}


class RenderLoop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        prog = self.prog = program.Program()
        log("program imported")
        self.cams = scene.cameras(cfg, "orbit")
        self.bg = program.background(cfg, device)
        cloud = scene.make_cloud(cfg, seed, device)
        self.pcams = [prog.camera(c, device) for c in self.cams]
        self.model = prog.model(cfg, cloud, scene.extent(self.cams))
        del cloud
        self.settings = prog.sized_settings(cfg, self.model, self.pcams,
                                            self.bg, log)
        rng = np.random.default_rng(int(seed))
        self.sample = set(int(i) for i in rng.choice(
            len(self.cams), size=mix["checked_frames"], replace=False))
        self.frame = 0
        self.kept = {}         # frame -> (view, image) of the sampled frames
        self.dropped = []
        tile = cfg["pipeline"]["tile"]
        self.facts = {"tiles": (-(-cfg["width"] // tile))
                      * (-(-cfg["height"] // tile))}
        log("inputs made, buffers sized")
        for _ in range(mix["warmup_frames"]):
            self.render()
        program.sync(device)
        self.dropped = []

    def render(self):
        view = self.frame % len(self.cams)
        with torch.no_grad():
            out = self.prog.renderer.render(
                self.pcams[view], self.model.params, self.model.state.alive,
                self.model.active_sh_degree, self.bg, self.settings)
        self.dropped.append(out["dropped"])
        return view, out["render"]

    def window(self, seconds: float) -> program.Window:
        """Frames until ``seconds`` have passed, each timed from its call
        to its synchronisation."""
        lat = []
        self.frame = 0
        t0 = time.perf_counter()
        last = None
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            view, img = self.render()
            program.sync(self.device)
            lat.append(time.perf_counter() - ts)
            if self.frame in self.sample:
                self.kept[self.frame] = (view, img)
            last = (self.frame, view, img)
            self.frame += 1
        t1 = time.perf_counter()
        if last is not None:
            self.kept[last[0]] = last[1:]
        failed = int((torch.stack(self.dropped) > 0).sum()) if lat else 0
        return program.Window(len(lat), t1 - t0, lat, failed)

    def outcome(self, win: program.Window) -> tuple[int, int]:
        """(attempted, failed) over the window's frames."""
        return win.ops, win.failed

    def end_to_end(self, win: program.Window) -> dict:
        return {"render_fps": win.ops / win.seconds,
                "render_p95_ms": float(
                    np.percentile(np.asarray(win.latencies), 95) * 1e3)}

    def steps(self, count: int, mark) -> list:
        """``count`` frames in host ranges "ngsbench.frame" and
        "ngsbench.sync"; returns their views."""
        views = []
        for _ in range(count):
            with mark("ngsbench.frame"):
                views.append(self.render()[0])
            self.frame += 1
            with mark("ngsbench.sync"):
                program.sync(self.device)
        return views

    def launches(self) -> dict:
        return self.prog.launches()

    def release(self):
        self.model = self.pcams = None
        self.dropped = []

    def reference(self, steady, views) -> tuple[dict, list]:
        """(the check's numbers, the counted frames' samples): the
        reference's renders of the kept frames' views; in a traced run,
        ``counted_frames`` of the traced window ``steady``'s frames
        (``views``) drawn from the seed, each with the reference's pair
        counts and K1's record of that frame (None where records are
        missing)."""
        ref_render.no_tf32()
        cfg = self.cfg
        sh, tile = cfg["sh_degree"], cfg["pipeline"]["tile"]
        cloud = scene.make_cloud(cfg, self.seed, self.device)
        pairs = []
        for frame in sorted(self.kept):
            view, img = self.kept[frame]
            out = ref_render.render(cloud, self.cams[view], sh, self.bg,
                                    tile)[0]
            pairs.append((img, out))
        numbers = check.image_numbers(pairs)
        del pairs
        samples = []
        if steady is not None and views:
            times = trace.per_op_times(steady, KERNELS, len(views))["K1"]
            rng = np.random.default_rng(int(self.seed))
            picks = sorted(rng.choice(
                len(views), size=min(self.mix["counted_frames"], len(views)),
                replace=False).tolist())
            for i in picks:
                c = ref_render.render(cloud, self.cams[views[i]], sh,
                                      self.bg, tile, counts=True)[3]
                samples.append({"K1": times[i] if times else None,
                                "counts": c})
        return numbers, samples


def setup(cfg: dict, mix: dict, seed: int, device, log,
          traced: bool) -> RenderLoop:
    return RenderLoop(cfg, mix, seed, device, log)


def control(cfg: dict, mix: dict, seed: int, device) -> dict:
    """{"control": numbers}: the reference in bfloat16 in the program's
    place, on views drawn from the seed as a run draws its checked
    frames."""
    ref_render.no_tf32()
    sh, tile = cfg["sh_degree"], cfg["pipeline"]["tile"]
    bg = program.background(cfg, device)
    cloud = scene.make_cloud(cfg, seed, device)
    cams = scene.cameras(cfg, "orbit")
    rng = np.random.default_rng(int(seed))
    views = rng.choice(len(cams), size=mix["checked_frames"],
                       replace=False).tolist()
    pairs = []
    for v in views:
        base = ref_render.render(cloud, cams[v], sh, bg, tile)[0]
        low = ref_render.render(cloud, cams[v], sh, bg, tile,
                                dtype=torch.bfloat16)[0]
        pairs.append((low, base))
    return {"control": check.image_numbers(pairs)}
