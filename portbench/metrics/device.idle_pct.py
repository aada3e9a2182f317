"""device.idle_pct: the share of the traced window in which no kernel,
copy or set ran on the device, 1 - busy / window (busy: the union of the
device's intervals, harness/trace.py::busy_us)."""


def read(ctx):
    tr = ctx.trace
    if tr.window_us <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
