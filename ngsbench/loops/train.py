"""Closed-loop training (a mix with ``"loop": "train"``).

One trainer: ``Trainer.step`` from iteration ``first_iteration`` on, one
camera a step, the cameras in seeded permutations of the configuration's
training views, against the benchmark's ground truth, which lives on the
device. Set-up runs the first ``checked_steps`` steps, which the
reference follows, and ``warmup_steps`` more before the window; the
window reports ``train_ms_per_iter``, its wall time over the steps in it.

Mix keys: ``first_iteration``, ``checked_steps``, ``warmup_steps``,
``tune_interval`` (the Trainer's capacity tuning), ``trace_ops`` (steps
in the traced window).
"""

from __future__ import annotations

import time

import torch

from ngsbench import check, program, scene, trace
from ngsbench.reference import render as ref_render
from ngsbench.reference import train as ref_train

KIND = "train"
# the kernels whose records this loop's readers need: label -> name
KERNELS = {k: program.KERNEL_NAMES[k] for k in ("K1", "K2")}


class TrainLoop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log,
                 traced: bool):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        prog = self.prog = program.Program()
        log("program imported")
        self.cams = scene.cameras(cfg, "train")
        self.extent = scene.extent(self.cams)
        self.gt = scene.make_images(cfg, seed, len(self.cams), device)
        self.bg = program.background(cfg, device)
        cloud = scene.make_cloud(cfg, seed, device)
        self.pcams = [prog.camera(c, device) for c in self.cams]
        model = prog.model(cfg, cloud, self.extent)
        del cloud
        settings = prog.sized_settings(cfg, model, self.pcams, self.bg, log)
        self.trainer = prog.loop.Trainer(
            gaussians=model, opt=prog.optim.OptimizationParams(),
            settings=settings, white_background=cfg["white_background"],
            cameras_extent=self.extent, seed=int(seed) % (1 << 63),
            tune_interval=mix["tune_interval"])
        self.order = program.camera_stream(seed, len(self.cams))
        self.iteration = mix["first_iteration"]
        self.checked_views = []
        self.metrics = []
        tile = cfg["pipeline"]["tile"]
        self.facts = {"tiles": (-(-cfg["width"] // tile))
                      * (-(-cfg["height"] // tile)),
                      "trainable": cfg["n_gaussians"]
                      * cfg["trainable_per_gaussian"]}
        log("inputs made, buffers sized")
        # the checked steps, profiled in a traced run: the reference counts
        # their work on its own state, which the rooflines need
        self.checked_window = None
        if traced:
            with trace.profiled(device) as got:
                with trace.mark("ngsbench.window"):
                    self.checked = self._checked()
                    program.sync(device)
            self.checked_window = got[0]
        else:
            self.checked = self._checked()
        for _ in range(mix["warmup_steps"]):
            self.step()
        program.sync(device)

    def step(self):
        view = next(self.order)
        m = self.trainer.step(self.pcams[view], self.gt[view],
                              self.iteration)
        self.iteration += 1
        self.metrics.append((m["loss"], m["dropped"]))
        return view

    def _checked(self) -> dict:
        """The first ``checked_steps`` steps, with what the check reads:
        each step's loss, the first gradient (from Adam's first moment
        after one step) and the parameters' change over them, per leaf."""
        tr = self.trainer
        start = {k: getattr(tr.ts.params, k) for k in tr.tx.lrs}
        out = {"loss": [], "grad_norm": None}
        for i in range(self.mix["checked_steps"]):
            self.checked_views.append(self.step())
            out["loss"].append(float(self.metrics[-1][0]))
            if i == 0:
                out["grad_norm"] = {
                    k: float(g.mu.norm()) / (1.0 - tr.tx.b1)
                    for k, g in tr.ts.opt_state.items()}
        out["change_norm"] = {k: float((getattr(tr.ts.params, k) - v).norm())
                              for k, v in start.items()}
        del start
        tr.sync_model()
        return out

    def window(self, seconds: float) -> program.Window:
        """Steps until ``seconds`` have passed, then a synchronisation:
        the clock runs from the first call to the end of that."""
        first = len(self.metrics)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.step()
            n += 1
        program.sync(self.device)
        t1 = time.perf_counter()
        return program.Window(n, t1 - t0, [], self.failures(first))

    def outcome(self, win: program.Window) -> tuple[int, int]:
        """(attempted, failed) over every step the run made."""
        return len(self.metrics), self.failures()

    def end_to_end(self, win: program.Window) -> dict:
        return {"train_ms_per_iter": win.seconds / win.ops * 1e3}

    def steps(self, count: int, mark) -> list:
        """``count`` steps, each in a host range "ngsbench.step", then one
        "ngsbench.sync"; returns their views."""
        views = []
        for _ in range(count):
            with mark("ngsbench.step"):
                views.append(self.step())
        with mark("ngsbench.sync"):
            program.sync(self.device)
        return views

    def launches(self) -> dict:
        return self.prog.launches()

    def failures(self, first: int = 0) -> int:
        """Steps from ``first`` on that dropped instances or whose loss is
        not finite."""
        ms = self.metrics[first:]
        if not ms:
            return 0
        loss = torch.stack([m[0] for m in ms])
        dropped = torch.stack([m[1] for m in ms])
        return int(((dropped > 0) | ~torch.isfinite(loss)).sum())

    def release(self):
        self.trainer = self.pcams = None
        self.metrics = []

    def reference(self, steady, views) -> tuple[dict, list]:
        """(the check's numbers, the counted steps' samples): the reference
        follows the checked steps from the seed's cloud; each sample holds
        the reference's pair counts of a checked step and, in a traced
        run, K1's and K2's records in it (None where a record is
        missing). The traced window (``steady``, ``views``) is not
        needed: the checked steps are profiled in set-up."""
        ref_render.no_tf32()
        cfg = self.cfg
        cloud = scene.make_cloud(cfg, self.seed, self.device)
        views = self.checked_views
        ref = ref_train.steps(cloud, [self.cams[v] for v in views],
                              [self.gt[v] for v in views], self.bg,
                              cfg["sh_degree"], cfg["pipeline"]["tile"],
                              self.extent)
        numbers = check.train_numbers(self.checked, ref)
        samples = []
        if self.checked_window is not None:
            times = trace.per_op_times(self.checked_window, KERNELS,
                                       len(views))
            for i, c in enumerate(ref["counts"]):
                samples.append({k: (v[i] if v else None)
                                for k, v in times.items()} | {"counts": c})
        return numbers, samples


def setup(cfg: dict, mix: dict, seed: int, device, log,
          traced: bool) -> TrainLoop:
    return TrainLoop(cfg, mix, seed, device, log, traced)


def control(cfg: dict, mix: dict, seed: int, device) -> dict:
    """{variant: numbers} that set the check's upper readings, on the
    inputs a run hands the program: the reference in bfloat16 in the
    program's place ("control"), and with half of each image's rows left
    out of the loss, the mean over the rest ("half_batch")."""
    ref_render.no_tf32()
    cams = scene.cameras(cfg, "train")
    gt = scene.make_images(cfg, seed, len(cams), device)
    order = program.camera_stream(seed, len(cams))
    views = [next(order) for _ in range(mix["checked_steps"])]
    args = (scene.make_cloud(cfg, seed, device), [cams[v] for v in views],
            [gt[v] for v in views], program.background(cfg, device),
            cfg["sh_degree"], cfg["pipeline"]["tile"], scene.extent(cams))
    base = ref_train.steps(*args)
    out = {"control": check.train_numbers(
        ref_train.steps(*args, dtype=torch.bfloat16), base)}
    half = ref_train.steps(*args, loss_rows=cfg["height"] // 2)
    out["half_batch"] = check.train_numbers(half, base)
    return out
