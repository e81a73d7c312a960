"""kernels_per_iter: device kernels in the traced window of training steps,
over the steps in it."""


def read(t):
    if t.kind != "train" or not t.ops:
        return None
    return t.kernels / t.ops
