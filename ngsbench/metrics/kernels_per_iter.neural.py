"""kernels_per_iter.neural: device kernels in the traced window of neural
training steps, over the steps in it."""


def read(t):
    if t.kind != "neural_train" or not t.ops:
        return None
    return t.kernels / t.ops
