"""scaffold_step_mfu: the operations a Scaffold-GS training step needs
(``scaffold_counts.step_ops``: the MLPs over the visible anchors, the
generation, the projections, the blend, the loss and Adam, averaged over
the counted steps) over the traced window's wall time per step, as a share
of the card's FP32 peak."""

from ngsbench import counts, scaffold_counts


def read(t):
    if t.kind != "scaffold_train" or not t.samples or not t.ops:
        return None
    cfg = t.facts["widths"]
    ops = sum(scaffold_counts.step_ops(x["counts"], cfg, t.facts["trainable"])
              for x in t.samples) / len(t.samples)
    return 100.0 * ops / (t.window_s / t.ops) / counts.PEAK_FP32_OPS
