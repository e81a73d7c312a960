"""Closed-loop Scaffold-GS training (a mix with ``"loop":
"scaffold_train"``).

One trainer: ``ScaffoldTrainer.step`` of the port
(``neuralgaussiansplatting_torch.train.scaffold_loop``), as the train
entry's ``--model scaffold`` calls it, from iteration ``first_iteration``
on (after the original's anchor growing ends), one camera a step in seeded
permutations of the configuration's training views, the appearance
embedding indexed by the view, against the benchmark's ground truth on the
device. Each step runs the anchors' visibility prefilter, the MLP decode
into ``n_offsets`` neural Gaussians an anchor with the opacity gate, the
rasterizer with precomputed colours, L1 + SSIM + the scale regulariser,
autograd, and Adam over the anchors, the MLPs and the embedding; every
``tune_interval`` iterations the trainer re-buckets its instance buffers.

The anchors (``anchors``) and the MLPs' and embedding's weights
(``nets``) are drawn here from the seed at the configuration's sizes and
handed to the program, so that the configuration, not the program, decides
them: a program whose nets have other shapes is refused. The rates are the
configuration's.

Set-up sizes the instance buffers from a probe render of every training
view, with ``HEADROOM`` for the demand's rise as the MLPs train
(``program.size_from_probe``, as the garden cells do), and the rows into
which the trainer gathers the visible anchors from the most a view shows
(the trainer's ``anchor_capacity_for``), runs
``checked_steps`` steps, which the reference follows, and ``warmup_steps``
more. The window reports ``train_ms_per_iter``. A step fails when it
dropped instances, left visible anchors out of its rows or its loss is not
finite.

The check (``numbers``) holds the checked steps against
``reference.scaffold.steps`` from the same anchors and nets: ``loss_gap``
(the worst step's relative loss difference), ``grad_gap`` (the worst
leaf's norm of the first gradient's difference, Adam's first moment over
1 - beta1, over the larger of the reference leaf's norm and the median
leaf's; a leaf under a thousandth of the median is left out),
``change_norm_gap`` (the same of the norm of the parameters' change over
the checked steps) and ``gate_mismatch`` (the share of candidates whose
gate or whose anchor's visibility differs, the worst step).

Mix keys: ``first_iteration``, ``checked_steps``, ``warmup_steps``,
``tune_interval``, ``trace_ops`` (steps in the traced window).
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from ngsbench import check, program, scaffold_counts, scene, trace
from ngsbench.reference import render as ref_render
from ngsbench.reference import scaffold as ref_scaffold

KIND = "scaffold_train"
# the kernels whose records this loop's readers need: label -> name
KERNELS = {"PPF": scaffold_counts.FWD_KERNEL,
           "PPB": scaffold_counts.BWD_KERNEL}
# the buffers' room over the probes' demand: as the MLPs train from the
# seed's state a step's demand rises, by up to 1.35x the probes' in the
# first 400 steps on the card, and the trainer re-buckets only every
# tune_interval
HEADROOM = 1.5


def anchors(cfg: dict, seed: int, device) -> dict:
    """{leaf: tensor} of the seed's ``n_anchors`` anchors after training:
    positions uniform in ``anchors["box"]``; offsets normal with deviation
    ``offset_sigma`` (in units of l[:3]); features normal with deviation
    ``feat_sigma``; the six log-scalings normal with deviation
    ``log_scale_sigma`` around the log of the mean spacing (the cube's
    side over the cube root of the count) plus ``log_scale_shift``'s two
    values (the offsets' three, the scales' three)."""
    a = cfg["anchors"]
    n = int(cfg["n_anchors"])
    k = int(cfg["n_offsets"])
    g = scene.generator(seed, device, 5)
    lo, hi = a["box"]
    spacing = (hi - lo) / n ** (1.0 / 3.0)
    shift = torch.tensor([a["log_scale_shift"][0]] * 3
                         + [a["log_scale_shift"][1]] * 3, device=device)
    anchor = torch.rand((n, 3), generator=g, device=device) * (hi - lo) + lo
    offset = torch.randn((n, k, 3), generator=g, device=device)
    offset *= a["offset_sigma"]
    feat = torch.randn((n, cfg["feat_dim"]), generator=g, device=device)
    feat *= a["feat_sigma"]
    scaling = torch.randn((n, 6), generator=g, device=device)
    scaling = scaling * a["log_scale_sigma"] + math.log(spacing) + shift
    return {"anchor": anchor, "offset": offset, "anchor_feat": feat,
            "scaling": scaling}


def nets(cfg: dict, seed: int, device, views: int, anchor: dict,
         campos) -> dict:
    """The seed's MLP and embedding weights at the configuration's widths
    (``reference.scaffold.nets_shapes``' names), as a trained state's
    (``calibration``): drawn as PyTorch initialises the modules (weights
    and biases uniform in +-1 / sqrt(fan_in), the embedding standard
    normal), then the opacity MLP's output biases set so that a share
    ``kept_share`` of each offset's neural Gaussians is kept and the 95th
    percentile of its opacity is ``opacity_q95``, and the covariance MLP's
    scale outputs so that the scale factor's median is ``scale_factor``
    and its logit's interquartile range ``scale_iqr``, over the first
    ``sample`` anchors of ``anchor``
    (``anchors``), sample row ``i`` seen from the camera centre ``campos[i
    % len(campos)]`` (every training view's, so that no view decides it);
    before that, in those two MLPs, each
    hidden unit is scaled to the mean activation ``hidden_mean`` (what a
    PyTorch-initialised layer has on average). Without these steps the
    seed would decide the gate's share, the opacities and the Gaussians'
    sizes, and with them the step's cost: by 1.4 % between seeds on an
    H100 with only the share and the median calibrated, every rate at 0,
    and by 0.2-0.3 % with the nets the same for every seed."""
    g = scene.generator(seed, device, 6)
    out = {}
    shapes = ref_scaffold.nets_shapes(cfg, views)
    for name, shape in shapes.items():
        x = (torch.randn(shape, generator=g, device=device)
             if name.startswith("embedding")
             else torch.rand(shape, generator=g, device=device) * 2 - 1)
        if not name.startswith("embedding"):
            fan_in = shapes[name.replace(".bias", ".weight")][1]
            x = x / math.sqrt(fan_in)
        out[name] = x
    c = cfg["calibration"]
    k, cd = cfg["n_offsets"], cfg["cov_dim"]
    x = anchor["anchor"][:c["sample"]]
    m = x.shape[0]
    centres = torch.as_tensor(np.asarray(campos), device=device)
    d = x - centres[torch.arange(m, device=device) % centres.shape[0]]
    local = torch.cat([anchor["anchor_feat"][:m],
                       d / d.norm(dim=1, keepdim=True)], 1)
    linear = torch.nn.functional.linear

    def fit(name, rows, quantiles, targets):
        """Scale ``name``'s hidden units to the mean activation
        ``hidden_mean`` over the sample, then map each of its output
        ``rows`` affinely (that row of the last weight and its bias) so
        that its pre-activation's two ``quantiles`` over the sample fall
        on ``targets``."""
        w1, b1 = out[f"{name}.0.weight"], out[f"{name}.0.bias"]
        f = c["hidden_mean"] / torch.relu(linear(local, w1, b1)).mean(0)
        w1, b1 = w1 * f[:, None], b1 * f
        w2 = out[f"{name}.2.weight"].clone()
        b2 = out[f"{name}.2.bias"].clone()
        z = linear(torch.relu(linear(local, w1, b1)), w2[rows])
        q = torch.quantile(z, torch.tensor(quantiles, device=device), 0)
        g = (targets[1] - targets[0]) / (q[1] - q[0])
        w2[rows] = w2[rows] * g[:, None]
        b2[rows] = targets[0] - q[0] * g
        out.update({f"{name}.0.weight": w1, f"{name}.0.bias": b1,
                    f"{name}.2.weight": w2, f"{name}.2.bias": b2})

    every = torch.arange(k, device=device)
    # the gate at the kept share's quantile, and the opacity's upper tail
    fit("mlp_opacity", every, [1.0 - c["kept_share"], 0.95],
        [0.0, math.atanh(c["opacity_q95"])])
    # the scale factor's median and quartiles (as pre-sigmoid logits)
    logit = math.log(c["scale_factor"] / (1.0 - c["scale_factor"]))
    fit("mlp_cov", (every[:, None] * cd + torch.arange(3, device=device)
                    ).reshape(-1), [0.25, 0.75],
        [logit - c["scale_iqr"] / 2, logit + c["scale_iqr"] / 2])
    return out


def _worst(gap: dict, scale: dict) -> float:
    median = statistics.median(scale.values())
    return max(gap[k] / max(scale[k], median) for k in scale)


def numbers(prog: dict, ref: dict, k: int) -> dict:
    """The check's numbers of ``prog`` ("loss" [per step], "grad" {leaf:
    first gradient}, "change_norm" {leaf: norm}, "gate" and "visible"
    [per step]) against the reference's ``ref`` (``reference.scaffold.
    steps``)."""
    norms = {n: float(g.norm()) for n, g in ref["grad"].items()}
    median = statistics.median(norms.values())
    leaves = [n for n in norms if norms[n] >= check.NOUGHT * median]
    grad = _worst({n: float((prog["grad"][n].float() - ref["grad"][n])
                            .norm()) for n in leaves},
                  {n: norms[n] for n in leaves})
    moved = ref["change_norm"]
    change = _worst({n: abs(prog["change_norm"][n] - moved[n])
                     for n in leaves}, {n: moved[n] for n in leaves})
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                    ref["loss"]))
    gate = 0.0
    for gp, gr, vp, vr in zip(prog["gate"], ref["gate"], prog["visible"],
                              ref["visible"]):
        differ = (gp.to(gr.device) != gr) | torch.repeat_interleave(
            vp.to(vr.device) != vr, k)
        gate = max(gate, float(differ.float().mean()))
    return {"loss_gap": loss, "grad_gap": grad, "change_norm_gap": change,
            "gate_mismatch": gate}


class ScaffoldTrainLoop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log,
                 traced: bool):
        from neuralgaussiansplatting_torch import gaussian_renderer
        from neuralgaussiansplatting_torch.models import scaffold
        from neuralgaussiansplatting_torch.ops import preprocess
        from neuralgaussiansplatting_torch.train import scaffold_loop
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.sl, self.pp = scaffold_loop, preprocess
        self.renderer = gaussian_renderer
        prog = self.prog = program.Program()
        log("program imported")
        self.cams = scene.cameras(cfg, "train")
        self.extent = scene.extent(self.cams)
        self.gt = scene.make_images(cfg, seed, len(self.cams), device)
        self.bg = program.background(cfg, device)
        self.pcams = [prog.camera(c, device) for c in self.cams]
        self.start = anchors(cfg, seed, device)
        self.nets = nets(cfg, seed, device, len(self.cams), self.start,
                         [c.campos for c in self.cams])
        want = scaffold.mlp_shapes(len(self.cams))
        for name, x in self.nets.items():
            if tuple(want.get(name, ())) != tuple(x.shape):
                raise ValueError(f"the program's {name!r} is "
                                 f"{want.get(name)}, the configuration's "
                                 f"{tuple(x.shape)}")
        params = scaffold.ScaffoldParams(
            **{k: v.clone() for k, v in self.start.items()})
        settings, anchor_capacity = self._sized(params, log)
        r = cfg["rates"]
        opt = scaffold_loop.ScaffoldOptimizationParams(
            position_lr_init=r["anchor"][0], position_lr_final=r["anchor"][1],
            offset_lr_init=r["offset"][0], offset_lr_final=r["offset"][1],
            feature_lr=r["anchor_feat"], scaling_lr=r["scaling"],
            mlp_opacity_lr_init=r["mlp_opacity"][0],
            mlp_opacity_lr_final=r["mlp_opacity"][1],
            mlp_cov_lr_init=r["mlp_cov"][0], mlp_cov_lr_final=r["mlp_cov"][1],
            mlp_color_lr_init=r["mlp_color"][0],
            mlp_color_lr_final=r["mlp_color"][1],
            appearance_lr_init=r["embedding_appearance"][0],
            appearance_lr_final=r["embedding_appearance"][1],
            max_steps=r["max_steps"], lambda_dssim=cfg["lambda_dssim"])
        self.trainer = scaffold_loop.ScaffoldTrainer(
            params, {k: v.clone() for k, v in self.nets.items()},
            anchor_capacity=anchor_capacity, settings=settings,
            opt=opt, white_background=cfg["white_background"],
            cameras_extent=self.extent,
            first_iteration=mix["first_iteration"],
            tune_interval=mix["tune_interval"])
        self.order = program.camera_stream(seed, len(self.cams))
        self.checked_views = []
        self.metrics = []
        self.facts = {"trainable": sum(v.numel() for v in self.start.values())
                      + sum(v.numel() for v in self.nets.values()),
                      "n_offsets": cfg["n_offsets"],
                      "widths": {k: cfg[k] for k in (
                          "feat_dim", "n_offsets", "mlp_hidden",
                          "appearance_dim", "cov_dim")}}
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

    def _sized(self, params, log):
        """(settings, anchor capacity) whose buffers fit every training
        view with room for the demand's rise as the MLPs train: a probe
        render of each under ``no_grad``, each instance demand times
        ``HEADROOM``, then the garden cells' rule for the instance buffer
        (``program.size_from_probe``: the power of two above 1.15 x), the
        packed buffer as large unless its own rule asks for more,
        ``max_per_tile`` doubled from 4096 until it holds the densest tile;
        the anchors' rows by the trainer's own rule
        (``anchor_capacity_for``) from the most visible anchors of a
        view."""
        prog, cfg = self.prog, self.cfg
        nets = self.nets

        def probe(views, capacity):
            settings = prog.settings(cfg, capacity=capacity,
                                     max_per_tile=program.PROBE_MAX_PER_TILE)
            demand = torch.zeros(4, dtype=torch.int64, device=self.device)
            with torch.no_grad():
                for v in views:
                    out = self.renderer.render_scaffold(
                        self.pcams[v], v, params, nets, self.bg, settings,
                        params.anchor.shape[0])
                    got = torch.stack([out["num_rendered"].long(),
                                       out["aligned_demand"].long(),
                                       out["max_per_tile"].long(),
                                       out["visible_anchors"].long()])
                    demand = torch.maximum(demand, got)
            return [int(x) for x in demand.tolist()]

        views = list(range(len(self.pcams)))
        first = probe(views[:1], program.PROBE_CAPACITY)[0]
        capacity = program.size_from_probe(first, 0)[0]
        rendered, aligned, tile_max, visible = probe(views, capacity)
        if rendered > capacity:
            rendered, aligned, tile_max, visible = probe(
                views, program.PROBE_CAPACITY)
        # the packed buffer as large as the instance buffer: the probes'
        # demand moves with the seed by some per cent, and the step's time
        # with the packed buffer's size, which a power of two holds still
        cap = program.size_from_probe(int(rendered * HEADROOM), 0)[0]
        kcap = max(cap, program.size_from_probe(0, int(aligned
                                                        * HEADROOM))[1])
        per_tile = program.MAX_PER_TILE
        while per_tile < tile_max * HEADROOM:
            per_tile *= 2
        rows = self.sl.anchor_capacity_for(visible)
        log(f"probe: {len(views)} views, instances {rendered}, aligned "
            f"{aligned}, densest tile {tile_max}, visible anchors {visible} "
            f"-> capacity {cap}, packed {kcap}, max_per_tile {per_tile}, "
            f"anchor rows {rows}")
        return prog.settings(cfg, capacity=cap, packed_capacity=kcap,
                             max_per_tile=per_tile), rows

    def step(self):
        view = next(self.order)
        m = self.trainer.step(self.pcams[view], self.gt[view], view)
        self.metrics.append((m["loss"], m["dropped"] + m["anchor_overflow"]))
        self.last = m
        return view

    def _leaves(self) -> dict:
        ts = self.trainer.ts
        return ts.params._asdict() | ts.nets

    def _in_anchor_order(self, m) -> tuple:
        """A step's (gate, visible) of every candidate and anchor, in the
        anchors' order: the decoded rows (``m["rows"]``, distinct) put
        back in their anchors' places, the other anchors neither visible
        nor kept."""
        n, k = self.start["anchor"].shape[0], self.cfg["n_offsets"]
        visible = m["visible"].new_zeros(n)
        gate = m["gate"].new_zeros((n, k))
        visible[m["rows"]] = m["visible"]
        gate[m["rows"]] = m["gate"].reshape(-1, k)
        return gate.reshape(-1), visible

    def _checked(self) -> dict:
        """The first ``checked_steps`` steps, with what the check reads:
        each step's loss, gate and visible anchors, the first gradient
        (Adam's first moment after one step over 1 - beta1) and the norm
        of the change over them, per leaf."""
        tr = self.trainer
        out = {"loss": [], "gate": [], "visible": []}
        for i in range(self.mix["checked_steps"]):
            self.checked_views.append(self.step())
            out["loss"].append(float(self.metrics[-1][0]))
            gate, visible = self._in_anchor_order(self.last)
            out["gate"].append(gate)
            out["visible"].append(visible)
            if i == 0:
                out["grad"] = {k: s.mu / (1.0 - tr.tx.b1)
                               for k, s in tr.ts.opt_state.items()}
        start = self.start | self.nets
        out["change_norm"] = {k: float((v - start[k]).norm())
                              for k, v in self._leaves().items()}
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
        return {"PPF": self.pp.launches, "PPB": self.pp.bwd_launches}

    def failures(self, first: int = 0) -> int:
        """Steps from ``first`` on that dropped instances or visible
        anchors, or whose loss is not finite."""
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
        follows the checked steps from the same anchors and nets; each
        sample holds the reference's counts of a checked step and, in a
        traced run, the preprocess kernels' records in it ("preprocess_s":
        its two forward launches and one backward, or None where the
        profiler kept another number)."""
        ref_render.no_tf32()
        vs = self.checked_views
        ref = ref_scaffold.steps(
            self.start, self.nets, [self.cams[v] for v in vs], vs,
            [self.gt[v] for v in vs], self.bg, extent=self.extent,
            **ref_scaffold.settings(self.cfg, self.mix["first_iteration"]))
        out = numbers(self.checked, ref, self.cfg["n_offsets"])
        samples = []
        if self.checked_window is not None:
            fwd = self.checked_window.kernels(KERNELS["PPF"])
            bwd = self.checked_window.kernels(KERNELS["PPB"])
            whole = len(fwd) == 2 * len(vs) and len(bwd) == len(vs)
            for i, c in enumerate(ref["counts"]):
                t = (fwd[2 * i] + fwd[2 * i + 1] + bwd[i]) if whole else None
                samples.append({"preprocess_s": t, "counts": c})
        return out, samples


def setup(cfg: dict, mix: dict, seed: int, device, log,
          traced: bool) -> ScaffoldTrainLoop:
    return ScaffoldTrainLoop(cfg, mix, seed, device, log, traced)


def control(cfg: dict, mix: dict, seed: int, device) -> dict:
    """{variant: numbers} that set the check's upper readings, on the
    anchors and nets a run hands the program: the reference in bfloat16
    in the program's place ("control"), with its MLPs alone in bfloat16
    ("mlp_bf16") or with TF32's operands ("mlp_tf32", the step a port that
    let TF32 into the MLPs would take), and with half of each image's rows
    left out of the loss, the mean over the rest ("half_batch")."""
    ref_render.no_tf32()
    cams = scene.cameras(cfg, "train")
    gt = scene.make_images(cfg, seed, len(cams), device)
    order = program.camera_stream(seed, len(cams))
    views = [next(order) for _ in range(mix["checked_steps"])]
    start = anchors(cfg, seed, device)
    args = (start, nets(cfg, seed, device, len(cams), start,
                        [c.campos for c in cams]),
            [cams[v] for v in views], views, [gt[v] for v in views],
            program.background(cfg, device))
    kw = ref_scaffold.settings(cfg, mix["first_iteration"]) | {
        "extent": scene.extent(cams)}
    base = ref_scaffold.steps(*args, **kw)
    k = cfg["n_offsets"]

    def variant(**kv):
        r = ref_scaffold.steps(*args, **kw, **kv)
        return numbers(r, base, k)

    return {"control": variant(dtype=torch.bfloat16),
            "mlp_bf16": variant(mlp_dtype=torch.bfloat16),
            "mlp_tf32": variant(mlp_tf32=True),
            "half_batch": variant(loss_rows=cfg["height"] // 2)}
