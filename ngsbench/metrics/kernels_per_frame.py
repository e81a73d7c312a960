"""kernels_per_frame: device kernels in the traced window of rendered
frames, over the frames in it."""


def read(t):
    if t.kind != "render" or not t.ops:
        return None
    return t.kernels / t.ops
