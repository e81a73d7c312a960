"""device_idle_pct: the share of the traced window in which no kernel, copy
or fill ran on the device, from the profiler's timeline (the union of
their intervals, within the window's host span)."""


def read(t):
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
