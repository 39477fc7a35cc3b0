"""device_idle.serve: the share of the traced window in which no operation
ran on the device (1 - the union of kernel, copy and fill intervals over
the window's host-clock length), from torch.profiler."""

KIND = "serve_lm"


def read(r):
    t = r.get("trace")
    if r.get("kind") != KIND or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
