"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference, number by number, each against its
limit (``limits/<cell>.json``).

Training: each checked step's loss, the first step's gradient as Adam got
it and the parameters' change over the checked steps, each per leaf as a
gap of norms: |program's norm - reference's| over the reference's norm of
that leaf or of the median leaf, whichever is larger, the worst leaf read.
A leaf whose reference gradient is under a thousandth of the median
leaf's (the neural features, which never reach the image) moves by
round-off alone under Adam and is left out.

Rendering: the sampled frames' images against the reference's renders of
the same views, by the mean and the largest absolute pixel difference.
"""

from __future__ import annotations

import statistics

NOUGHT = 1e-3


def _gap(prog: dict, ref: dict, scale_of: dict) -> float:
    """The worst leaf's gap of norms; ``scale_of`` (the reference's first
    gradient norms) decides which leaves count."""
    median = statistics.median(scale_of.values())
    return max(abs(prog[k] - r) / max(r, median) for k, r in ref.items()
               if scale_of[k] >= NOUGHT * median)


def train_numbers(prog: dict, ref: dict) -> dict:
    """{name: value} of a training cell's numbers; ``prog`` and ``ref``
    hold "loss" (per step), "grad_norm" and "change_norm" (per leaf)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                    ref["loss"]))
    grad = _gap(prog["grad_norm"], ref["grad_norm"], ref["grad_norm"])
    change = _gap(prog["change_norm"], ref["change_norm"], ref["grad_norm"])
    return {"loss_gap": loss, "grad_norm_gap": grad,
            "change_norm_gap": change}


def image_numbers(pairs) -> dict:
    """{name: value} of a render cell's numbers over (program image,
    reference image) pairs."""
    mean, worst = 0.0, 0.0
    for p, r in pairs:
        d = (p.float() - r.float()).abs()
        mean = max(mean, float(d.mean()))
        worst = max(worst, float(d.max()))
    return {"image_mean_abs": mean, "image_max_abs": worst}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}). A
    number that is not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out

