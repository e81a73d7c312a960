"""render_mfu: the operations a frame needs (``counts.step_ops``, averaged
over the counted frames) over the traced window's wall time per frame, as
a share of the card's FP32 peak."""

from ngsbench import counts


def read(t):
    if t.kind != "render" or not t.samples or not t.ops:
        return None
    ops = sum(counts.step_ops(x["counts"], "render")
              for x in t.samples) / len(t.samples)
    return 100.0 * ops / (t.window_s / t.ops) / counts.PEAK_FP32_OPS
