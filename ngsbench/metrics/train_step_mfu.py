"""train_step_mfu: the operations a training step needs
(``counts.step_ops``, averaged over the counted steps) over the traced
window's wall time per step, as a share of the card's FP32 peak."""

from ngsbench import counts


def read(t):
    if t.kind != "train" or not t.samples or not t.ops:
        return None
    ops = sum(counts.step_ops(x["counts"], "train", t.facts["trainable"])
              for x in t.samples) / len(t.samples)
    return 100.0 * ops / (t.window_s / t.ops) / counts.PEAK_FP32_OPS
