"""neural_step_mfu: the decoders' convolution operations of a neural
training step (``neural_counts.step_ops``, from the view's shape) over the
traced window's wall time per step, as a share of the card's dense TF32
peak: the convolutions run on the tensor cores in TF32."""

from ngsbench import neural_counts


def read(t):
    if t.kind != "neural_train" or not t.ops or "conv_ops" not in t.facts:
        return None
    return (100.0 * t.facts["conv_ops"] / (t.window_s / t.ops)
            / neural_counts.PEAK_TF32_OPS)
