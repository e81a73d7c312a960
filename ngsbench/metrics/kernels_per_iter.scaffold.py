"""kernels_per_iter.scaffold: device kernels in the traced window of
Scaffold-GS training steps, over the steps in it."""


def read(t):
    if t.kind != "scaffold_train" or not t.ops:
        return None
    return t.kernels / t.ops
