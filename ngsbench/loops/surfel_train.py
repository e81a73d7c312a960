"""Closed-loop 2D Gaussian Splatting training (a mix with ``"loop":
"surfel_train"``).

One trainer: the port's ``Trainer.step`` over surfels, as the train entry's
``--model 2dgs`` calls it, from iteration ``first_iteration`` on (after
densification ends, both regularisers on), one camera a step in seeded
permutations of the configuration's training views, against the
benchmark's ground truth on the device. Each step runs the preprocess's
surfel variant, binning, the surfel blend both ways, L1 + SSIM, the normal
and distortion regularisers, autograd and Adam; every ``tune_interval``
iterations the trainer re-buckets its instance buffers.

The surfels are garden840's seeded cloud generator with its first two
log-scales (``cloud``) and the configuration's own log-scale shift, which
sizes them as a trained model's (a few pixels, so that the ray-splat
intersection, not the low-pass filter, sets most pairs' alpha), handed to
the program, so that the configuration decides them. Set-up sizes the instance buffers from a probe render of every
training view (``program.Program.sized_settings``, as the garden cells
do), runs ``checked_steps`` steps, which the reference follows, and
``warmup_steps`` more. The window reports ``train_ms_per_iter``. A step
fails when it dropped instances or its loss is not finite.

The check (``numbers``) holds the checked steps against
``reference.surfel.steps`` from the same cloud, computed in float64
(``BASE``): ``loss_gap`` (the worst step's relative loss difference),
``grad_gap`` (the median leaf's norm of the first gradient's difference,
Adam's first moment over 1 - beta1, over the larger of the reference
leaf's norm and the median leaf's; a leaf under a thousandth of the median
is left out), ``change_norm_gap`` (the worst leaf's gap of the norm of the
parameters' change over the checked steps), ``aux_gap`` (the worst relative gap,
|program - reference| / |reference| in the 2-norm, of the first checked
step's depth and alpha maps) and ``normal_dist_gap`` (the same of its
normal and distortion maps). The base is float64, and the normal and
distortion maps have their own number, because float32 decides them less
well, in the program and the float32 reference alike (on the card): the
squared distortion sum (m^2 A + M2 - 2 m M1 of nearly equal m, where a
pixel's surfels lie at nearly one depth) cancels to ~3-11 %; the normal
map lies ~1e-4 from float64 and up to ~2e-3 on some seeds, where depth
and alpha lie ~5e-6; and the xyz and rotation gradients lie ~1-8 % and
up to ~46 % on some seeds, where the other leaves lie ~1e-4-3e-3, so
``grad_gap`` reads the median leaf. The later steps' maps start from states
that Adam's steps of near-zero gradient elements (a move of the rate
either way) already set apart.

Mix keys: ``first_iteration``, ``checked_steps``, ``warmup_steps``,
``tune_interval``, ``trace_ops`` (steps in the traced window).
"""

from __future__ import annotations

import statistics
import time

import torch

from ngsbench import check, program, scene, surfel_counts, trace
from ngsbench.reference import render as ref_render
from ngsbench.reference import surfel as ref_surfel

KIND = "surfel_train"
# the precision of the reference the check holds the program to
BASE = torch.float64
# the kernels whose records this loop's readers need: label -> name
KERNELS = {"SBF": surfel_counts.FWD_KERNEL, "SBB": surfel_counts.BWD_KERNEL,
           "SPF": surfel_counts.PP_FWD_KERNEL,
           "SPB": surfel_counts.PP_BWD_KERNEL}
# the reference's leaves, the program's by the same names
LEAVES = ref_surfel.LEAVES
# the maps aux_gap reads: the program's render keys and the reference's
MAPS = {"rend_depth": "depth", "rend_alpha": "alpha"}
# the maps normal_dist_gap reads
LOOSE = {"rend_normal": "normal", "rend_dist": "dist"}


def cloud(cfg: dict, seed: int, device) -> dict:
    """The seed's cloud of ``cfg["cloud"]`` (``scene.make_cloud``, garden840's
    generator) as surfels: the first ``cfg["scales"]`` log-scales of
    each."""
    c = scene.make_cloud(cfg, seed, device)
    c["scaling"] = c["scaling"][:, :cfg["scales"]].contiguous()
    return c


def _gaps(gap: dict, scale: dict) -> list:
    """Each leaf's gap over the larger of its scale and the median leaf's."""
    median = statistics.median(scale.values())
    return [gap[k] / max(scale[k], median) for k in scale]


def numbers(prog: dict, ref: dict) -> dict:
    """The check's numbers of ``prog`` ("loss" [per step], "grad" {leaf:
    first gradient}, "change_norm" {leaf: norm}, "maps" [per step, {render
    key: map}]) against the reference's ``ref`` (``reference.surfel.
    steps``)."""
    norms = {n: float(g.norm()) for n, g in ref["grad"].items()}
    median = statistics.median(norms.values())
    leaves = [n for n in norms if norms[n] >= check.NOUGHT * median]
    grad = statistics.median(_gaps(
        {n: float((prog["grad"][n].double().to(ref["grad"][n].device)
                   - ref["grad"][n].double()).norm()) for n in leaves},
        {n: norms[n] for n in leaves}))
    moved = ref["change_norm"]
    change = max(_gaps({n: abs(prog["change_norm"][n] - moved[n])
                        for n in leaves}, {n: moved[n] for n in leaves}))
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                    ref["loss"]))
    pm, rm = prog["maps"][0], ref["maps"][0]

    def map_gap(key, name):
        r = rm[name].double()
        d = float((pm[key].double().to(r.device) - r).norm())
        return d / max(float(r.norm()), 1e-30)

    return {"loss_gap": loss, "grad_gap": grad, "change_norm_gap": change,
            "aux_gap": max(map_gap(k, n) for k, n in MAPS.items()),
            "normal_dist_gap": max(map_gap(k, n) for k, n in LOOSE.items())}


def settings(cfg: dict) -> dict:
    """The configuration's loss and rates as ``reference.surfel.steps``
    takes them."""
    return {"sh_degree": cfg["sh_degree"], "tile": cfg["pipeline"]["tile"],
            "lambda_dssim": cfg["lambda_dssim"],
            "lambda_normal": cfg["lambda_normal"],
            "lambda_dist": cfg["lambda_dist"],
            "depth_ratio": cfg["depth_ratio"], "rates": cfg["rates"]}


class SurfelTrainLoop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log,
                 traced: bool):
        # a port without the surfel path fails here, before any input is
        # made
        from neuralgaussiansplatting_torch.ops import preprocess
        from neuralgaussiansplatting_torch.ops import surfel_blend
        self.pp, self.sb = preprocess, surfel_blend
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        prog = self.prog = program.Program()
        log("program imported")
        self.cams = scene.cameras(cfg, "train")
        self.extent = scene.extent(self.cams)
        self.gt = scene.make_images(cfg, seed, len(self.cams), device)
        self.bg = program.background(cfg, device)
        self.pcams = [prog.camera(c, device) for c in self.cams]
        start = cloud(cfg, seed, device)
        model = prog.model(cfg, start, self.extent)
        del start
        settings = prog.sized_settings(cfg, model, self.pcams, self.bg, log)
        r = cfg["rates"]
        opt = prog.optim.OptimizationParams(
            position_lr_init=r["position"][0],
            position_lr_final=r["position"][1],
            position_lr_max_steps=r["position"][2], feature_lr=r["feature"],
            opacity_lr=r["opacity"], scaling_lr=r["scaling"],
            rotation_lr=r["rotation"], lambda_dssim=cfg["lambda_dssim"])
        self.trainer = prog.loop.Trainer(
            gaussians=model, opt=opt, settings=settings,
            white_background=cfg["white_background"],
            cameras_extent=self.extent, seed=int(seed) % (1 << 63),
            tune_interval=mix["tune_interval"],
            lambda_normal=cfg["lambda_normal"],
            lambda_dist=cfg["lambda_dist"], depth_ratio=cfg["depth_ratio"])
        self.order = program.camera_stream(seed, len(self.cams))
        self.iteration = mix["first_iteration"]
        self.checked_views = []
        self.metrics = []
        tile = cfg["pipeline"]["tile"]
        self.facts = {"tiles": (-(-cfg["width"] // tile))
                      * (-(-cfg["height"] // tile)),
                      "surfels": cfg["n_gaussians"],
                      "trainable": cfg["n_gaussians"]
                      * cfg["trainable_per_gaussian"]}
        log("inputs made, buffers sized")
        # the checked steps, profiled in a traced run: the reference counts
        # their work, which the rooflines and the step's share of the peak
        # need
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
        self.last = m
        return view

    def _checked(self) -> dict:
        """The first ``checked_steps`` steps, with what the check reads:
        each step's loss and maps, the first gradient (Adam's first moment
        after one step over 1 - beta1) and the norm of the change over
        them, per leaf."""
        tr = self.trainer
        start = {k: getattr(tr.ts.params, k) for k in LEAVES}
        out = {"loss": [], "maps": []}
        for i in range(self.mix["checked_steps"]):
            self.checked_views.append(self.step())
            out["loss"].append(float(self.metrics[-1][0]))
            out["maps"].append(self.last["maps"])
            if i == 0:
                out["grad"] = {k: tr.ts.opt_state[k].mu / (1.0 - tr.tx.b1)
                               for k in LEAVES}
        out["change_norm"] = {k: float((getattr(tr.ts.params, k) - v).norm())
                              for k, v in start.items()}
        self.last = None
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
        self.last = None
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
        self.last = None
        return views

    def launches(self) -> dict:
        return {"SBF": self.sb.launches, "SBB": self.sb.bwd_launches,
                "SPF": self.pp.launches, "SPB": self.pp.bwd_launches}

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
        self.trainer = self.pcams = self.last = None
        self.metrics = []

    def reference(self, steady, views) -> tuple[dict, list]:
        """(the check's numbers, the counted steps' samples): the reference
        follows the checked steps from the seed's cloud; each sample holds
        the reference's pair counts of a checked step and, in a traced
        run, the four kernels' records in it (None where a record is
        missing)."""
        ref_render.no_tf32()
        cfg = self.cfg
        vs = self.checked_views
        ref = ref_surfel.steps(cloud(cfg, self.seed, self.device),
                               [self.cams[v] for v in vs],
                               [self.gt[v] for v in vs], self.bg,
                               extent=self.extent, dtype=BASE,
                               **settings(cfg))
        out = numbers(self.checked, ref)
        samples = []
        if self.checked_window is not None:
            times = trace.per_op_times(self.checked_window, KERNELS, len(vs))
            for i, c in enumerate(ref["counts"]):
                samples.append({k: (v[i] if v else None)
                                for k, v in times.items()} | {"counts": c})
        return out, samples


def setup(cfg: dict, mix: dict, seed: int, device, log,
          traced: bool) -> SurfelTrainLoop:
    return SurfelTrainLoop(cfg, mix, seed, device, log, traced)


def control(cfg: dict, mix: dict, seed: int, device) -> dict:
    """{variant: numbers} that set the check's upper readings, on the
    inputs a run hands the program, each held to the ``BASE`` reference as
    the program is: the reference in bfloat16 in the program's place
    ("control"), and in ``BASE`` with half of each image's rows left out
    of the photometric term ("half_batch") or with 3DGS's affine (EWA)
    splat in place of the ray-splat intersection ("affine")."""
    ref_render.no_tf32()
    cams = scene.cameras(cfg, "train")
    gt = scene.make_images(cfg, seed, len(cams), device)
    order = program.camera_stream(seed, len(cams))
    views = [next(order) for _ in range(mix["checked_steps"])]
    args = (cloud(cfg, seed, device), [cams[v] for v in views],
            [gt[v] for v in views], program.background(cfg, device))
    kw = settings(cfg) | {"extent": scene.extent(cams)}
    base = ref_surfel.steps(*args, **kw, dtype=BASE)

    def variant(dtype=BASE, **kv):
        r = ref_surfel.steps(*args, **kw, dtype=dtype, **kv)
        r["maps"] = [{key: m[name] for key, name in (MAPS | LOOSE).items()}
                     for m in r["maps"]]
        return numbers(r, base)

    return {"control": variant(dtype=torch.bfloat16),
            "half_batch": variant(loss_rows=cfg["height"] // 2),
            "affine": variant(affine=True)}
