"""surfel_step_mfu: the operations a 2D Gaussian Splatting training step
needs (``surfel_counts.step_ops``: the projections, the surfel blend both
ways, the regularisers, the loss and Adam, averaged over the counted steps)
over the traced window's wall time per step, as a share of the card's FP32
peak."""

from ngsbench import counts, surfel_counts


def read(t):
    if t.kind != "surfel_train" or not t.samples or not t.ops:
        return None
    ops = sum(surfel_counts.step_ops(x["counts"], t.facts["trainable"])
              for x in t.samples) / len(t.samples)
    return 100.0 * ops / (t.window_s / t.ops) / counts.PEAK_FP32_OPS
