"""Closed-loop neural-feature training (a mix with ``"loop":
"neural_train"``): the fork's ``trainn.py`` with ``--sw 2``.

One trainer: ``NeuralTrainer(sw=2).step``, as the port's ``trainn`` entry
calls it, on frozen geometry, one camera a step, the cameras in seeded
permutations of the configuration's training views, against the
benchmark's ground truth on the device. The step renders through
``render2`` (K3's z-buffer and the feature map, the UNet and the CNN, the
denoiser), takes L1 + SSIM, its gradients by autograd, and Adam over the
features and the decoders; every 100 steps the trainer's own capacity
autotune reads the z-buffer's demand. The decoders run in float32 with
cuDNN's TF32 convolutions left as PyTorch sets them. Their UNet and CNN
weights are drawn here from the seed at the configuration's widths
(``decoders``; ``reference.neural.decoder_shapes`` names each) and copied
into the trainer's decoders before its first step, so that the
configuration, not the program, decides them: a program whose decoders
have other shapes is refused.

Set-up sizes the trainer's z-buffer capacity by its own rule (1.4 x the
demand, up to the next power of two, within [2^16, 2^24]) from a probe of
every training view's demand, so that the autotune has nothing to change
in the window; it runs ``checked_steps`` steps, which the reference
follows, and ``warmup_steps`` more. The window reports
``train_ms_per_iter``, its wall time over the steps in it. A step fails
when its loss is not finite or its z-buffer's demand exceeded the
capacity it ran with (winners may then be wrong).

The check (``numbers``) holds the checked steps against the reference
from the same features and decoders, each number per leaf (the features
and every UNet and CNN parameter) over the larger of the reference
leaf's norm and the median leaf's, the worst leaf read: ``grad_gap`` the
norm of the first gradient's (Adam's first moment over 1 - beta1)
difference from the reference's; ``change_norm_gap`` the gap of the norm
of the parameters' change over all the checked steps from the
reference's; and ``idxmap_mismatch`` the share of pixels whose z-buffer
winner differs, the worst view. The gradient is read by its difference,
not by a gap of norms: TF32 shifts leaf norms by 0.8-1.4e-3, near
bfloat16's 2.3-5.5e-3. The loss is not compared: the first step's reads
7e-6 to 3.5e-4 from TF32 and 8e-6 to 2e-3 from bfloat16, and the later
steps' part even between two float32 runs (Adam's first update is the
rate times the gradient's sign, which rounding flips where a gradient is
~0).

Mix keys: ``checked_steps``, ``warmup_steps``, ``trace_ops`` (steps in the
traced window).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from ngsbench import check, neural_counts, program, scene, trace
from ngsbench.reference import neural as ref_neural

KIND = "neural_train"
# the kernels whose records this loop's readers need: label -> name
KERNELS = {"K3": "zbuffer_fwd_kernel"}
PROBE_CAPACITY = 1 << 24        # the autotune's most


def capacity_for(demand: int) -> int:
    """``NeuralTrainer``'s autotune rule: 1.4 x the demand, up to the next
    power of two, within [2^16, 2^24]."""
    want = 1 << max(int(demand * 1.4) - 1, 1).bit_length()
    return min(max(want, 1 << 16), PROBE_CAPACITY)


def _worst(gap: dict, scale: dict) -> float:
    """The worst leaf's ``gap`` over the larger of its ``scale`` and the
    median leaf's."""
    median = statistics.median(scale.values())
    return max(gap[k] / max(scale[k], median) for k in scale)


def numbers(prog: dict, ref: dict, prog_idx: list) -> dict:
    """The check's numbers of ``prog`` ("grad" {leaf: first gradient},
    "change_norm" {leaf: norm}) against the reference's ``ref``
    (``reference.neural.steps``), over the reference's leaves;
    ``prog_idx`` the winners of the checked views. A leaf whose reference
    gradient is under a thousandth of the median leaf's is left out."""
    norms = {k: float(g.norm()) for k, g in ref["grad"].items()}
    median = statistics.median(norms.values())
    leaves = [k for k in norms if norms[k] >= check.NOUGHT * median]
    moved = ref["change_norm"]
    grad = _worst({k: float((prog["grad"][k] - ref["grad"][k]).norm())
                   for k in leaves}, {k: norms[k] for k in leaves})
    change = _worst({k: abs(prog["change_norm"][k] - moved[k])
                     for k in leaves}, {k: moved[k] for k in leaves})
    return {"grad_gap": grad, "change_norm_gap": change,
            "idxmap_mismatch": ref_neural.mismatch(prog_idx, ref["idx"])}


def features(cfg: dict, seed: int, device) -> torch.Tensor:
    """The seed's (N, 64) per-Gaussian features."""
    g = scene.generator(seed, device, 3)
    return cfg["features_sigma"] * torch.randn(
        (cfg["n_gaussians"], cfg["num_features"]), generator=g,
        device=device)


def decoders(cfg: dict, seed: int, device) -> dict:
    """The seed's UNet and CNN parameters at the configuration's widths,
    {name: tensor} (``reference.neural.decoder_shapes``' names): weights
    normal with deviation sqrt(2 / fan_in), fan_in the input channels
    times the kernel's area, as the fork initialises them; biases normal
    with deviation 0.01, so that a bias the program dropped shows."""
    g = scene.generator(seed, device, 4)
    out = {}
    for name, shape in ref_neural.settings(cfg)["shapes"].items():
        x = torch.randn(shape, generator=g, device=device)
        if len(shape) == 1:
            out[name] = 0.01 * x
            continue
        # a transposed convolution's weight is (in, out, kh, kw)
        cin = shape[0] if "ConvTranspose" in name else shape[1]
        out[name] = x * math.sqrt(2.0 / (cin * shape[2] * shape[3]))
    return out


def load_decoders(leaves: dict, drawn: dict):
    """Copy ``drawn`` into the program's decoder ``leaves`` of the same
    names; ValueError where one is missing or has another shape."""
    for name, x in drawn.items():
        if name not in leaves or tuple(leaves[name].shape) != x.shape:
            have = tuple(leaves[name].shape) if name in leaves else None
            raise ValueError(f"the program's decoder parameter {name!r} is "
                             f"{have}, the configuration's {tuple(x.shape)}")
        with torch.no_grad():
            leaves[name].copy_(x)


class NeuralTrainLoop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log,
                 traced: bool):
        from neuralgaussiansplatting_torch.ops import zbuffer_pallas
        from neuralgaussiansplatting_torch.train import neural_loop
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.log = log
        self.zbuf, self.nl = zbuffer_pallas, neural_loop
        prog = self.prog = program.Program()
        log("program imported")
        self.cams = scene.cameras(cfg, "train")
        self.gt = scene.make_images(cfg, seed, len(self.cams), device)
        cloud = scene.make_cloud(cfg, seed, device)
        self.pcams = [prog.camera(c, device) for c in self.cams]
        model = prog.model(cfg, cloud, scene.extent(self.cams))
        del cloud
        model.params = model.params._replace(
            features=features(cfg, seed, device))
        self.xyz = model.params.xyz
        self.alive = model.state.alive
        capacity = self._sized(log)
        opt = prog.optim.OptimizationParams(
            feature_lr=cfg["feature_lr"], lambda_dssim=cfg["lambda_dssim"])
        self.trainer = neural_loop.NeuralTrainer(
            model, sw=cfg["sw"], opt=opt, capacity=capacity,
            seed=int(seed) % (1 << 63))
        self.decoders = decoders(cfg, seed, device)
        load_decoders(neural_loop.decoder_leaves(self.trainer.ts.net_params),
                      self.decoders)
        self.order = program.camera_stream(seed, len(self.cams))
        self.metrics = []       # (loss, demand, capacity) per step
        self.retunes = []
        self.checked_views = []
        self.facts = {"conv_ops": neural_counts.step_ops(
            cfg, cfg["height"], cfg["width"])}
        log("inputs made, capacity sized")
        # the checked steps, profiled in a traced run: the reference counts
        # their z-buffer's work, which K3's roofline needs
        self.checked_window = None
        if traced:
            with trace.profiled(device) as got:
                with trace.mark("ngsbench.window"):
                    self.checked = self._checked()
                    program.sync(device)
            self.checked_window = got[0]
        else:
            self.checked = self._checked()
        self.idx = [self.zbuf.compute_idxmap_tiled(
            self.xyz, self.pcams[v], self.trainer.capacity, self.alive)[0]
            for v in self.checked_views]
        for _ in range(mix["warmup_steps"]):
            self.step()
        program.sync(device)

    def _sized(self, log) -> int:
        """The trainer's capacity for the largest z-buffer demand of the
        training views. The demand reads true while every instance fits:
        the first view, probed at the autotune's most, sets the others'
        probe, and all are probed again at the most where one overflows
        it."""
        def probe(cams, capacity):
            demand = torch.zeros((), dtype=torch.int64, device=self.device)
            with torch.no_grad():
                for cam in cams:
                    got = self.zbuf.compute_idxmap_tiled(
                        self.xyz, cam, capacity, self.alive)[2]
                    demand = torch.maximum(demand, got.long())
            return int(demand)

        probe_capacity = capacity_for(2 * probe(self.pcams[:1],
                                                PROBE_CAPACITY))
        demand = probe(self.pcams, probe_capacity)
        if demand > probe_capacity:
            demand = probe(self.pcams, PROBE_CAPACITY)
        capacity = capacity_for(demand)
        log(f"probe: {len(self.pcams)} views, largest z-buffer demand "
            f"{demand} -> capacity {capacity}")
        return capacity

    def step(self):
        view = next(self.order)
        capacity = self.trainer.capacity
        m = self.trainer.step(self.pcams[view], self.gt[view])
        if "retuned_idx_capacity" in m:
            self.retunes.append(m["retuned_idx_capacity"])
        self.metrics.append((m["loss"], m["idx_demand"], capacity))
        return view

    def _leaves(self) -> dict:
        tr = self.trainer
        return {"features": tr.ts.params.features} | {
            k: v.detach() for k, v in
            self.nl.decoder_leaves(tr.ts.net_params).items()}

    def _checked(self) -> dict:
        """The first ``checked_steps`` steps, with what the check reads:
        the first gradient (from Adam's first moment after one step) and
        the norm of the change over them, per leaf; the features they
        started from are kept for the reference."""
        tr = self.trainer
        self.start = {k: v.clone() for k, v in self._leaves().items()}
        self.checked_views.append(self.step())
        g_state, n_state = tr.ts.opt_state
        moments = {"features": g_state["features"]} | n_state
        out = {"grad": {k: s.mu / (1.0 - tr.txs[0].b1)
                        for k, s in moments.items()}}
        for _ in range(self.mix["checked_steps"] - 1):
            self.checked_views.append(self.step())
        out["change_norm"] = {k: float((v - self.start[k]).norm())
                              for k, v in self._leaves().items()}
        return out

    def window(self, seconds: float) -> program.Window:
        """Steps until ``seconds`` have passed, then a synchronisation:
        the clock runs from the first call to the end of that."""
        first = len(self.metrics)
        retunes = len(self.retunes)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.step()
            n += 1
        program.sync(self.device)
        t1 = time.perf_counter()
        self.log(f"capacity {self.trainer.capacity}, retuned in the window: "
                 f"{self.retunes[retunes:] or 'none'}")
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
        return {"K3": self.zbuf.launches}

    def failures(self, first: int = 0) -> int:
        """Steps from ``first`` on whose loss is not finite or whose
        z-buffer demand exceeded their capacity."""
        ms = self.metrics[first:]
        if not ms:
            return 0
        loss = torch.stack([m[0] for m in ms])
        demand = torch.stack([m[1].long() for m in ms])
        cap = torch.tensor([m[2] for m in ms], device=demand.device)
        return int(((demand > cap) | ~torch.isfinite(loss)).sum())

    def release(self):
        self.trainer = self.pcams = None
        self.metrics = []

    def reference(self, steady, views) -> tuple[dict, list]:
        """(the check's numbers, the counted steps' samples): the reference
        follows the checked steps from the same features and decoders;
        each sample holds the reference's z-buffer counts of a checked
        step and, in a traced run, K3's record in it (None where it is
        missing)."""
        ref_neural.no_tf32()
        vs = self.checked_views
        ref = ref_neural.steps(
            self.xyz, self.start["features"], self.decoders,
            [self.cams[v] for v in vs], [self.gt[v] for v in vs],
            **ref_neural.settings(self.cfg))
        out = numbers(self.checked, ref, self.idx)
        samples = []
        if self.checked_window is not None:
            times = trace.per_op_times(self.checked_window, KERNELS, len(vs))
            for i, c in enumerate(ref["counts"]):
                samples.append({k: (v[i] if v else None)
                                for k, v in times.items()} | {"counts": c})
        return out, samples


def setup(cfg: dict, mix: dict, seed: int, device, log,
          traced: bool) -> NeuralTrainLoop:
    return NeuralTrainLoop(cfg, mix, seed, device, log, traced)


def control(cfg: dict, mix: dict, seed: int, device) -> dict:
    """{variant: numbers} that set the check's upper readings, on the
    inputs and decoders a run hands the program: the reference with its
    decoders in bfloat16 in the program's place ("control", as
    ``mixed_precision`` runs them), with the depths
    the z-buffer compares rounded to bfloat16 ("zbuffer_bf16"), and with
    half of each image's rows left out of the loss, the mean over the rest
    ("half_batch")."""
    ref_neural.no_tf32()
    cams = scene.cameras(cfg, "train")
    gt = scene.make_images(cfg, seed, len(cams), device)
    order = program.camera_stream(seed, len(cams))
    views = [next(order) for _ in range(mix["checked_steps"])]
    args = (scene.make_cloud(cfg, seed, device)["xyz"],
            features(cfg, seed, device), decoders(cfg, seed, device),
            [cams[v] for v in views], [gt[v] for v in views])
    kw = ref_neural.settings(cfg)
    base = ref_neural.steps(*args, **kw)

    def variant(**kv):
        r = ref_neural.steps(*args, **kw, **kv)
        return numbers(r, base, r["idx"])

    return {"control": variant(dtype=torch.bfloat16),
            "zbuffer_bf16": variant(zbuffer_dtype=torch.bfloat16),
            "half_batch": variant(loss_rows=cfg["height"] // 2)}
