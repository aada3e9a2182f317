"""preprocess.roofline_pct: the pre-processor's bytes at the HBM peak over
the device time of the operations it launched.  Bytes: 5 a pixel
quantised (``harness/preprocess_bytes.py``), counted by the port's
``_ext.launches["pre_process_px"]``.  Time: for each of the program's
``rwt.pre_process`` spans in the window, the device operations launched
inside it (the host's kernel, set and copy launches in the span,
counted), taken in the device's order from the first that starts after
the span opened: the device is idle there, since the call before ended
with a synchronise, and runs one stream in launch order, while the
kernels themselves mostly run after the host has left the span.  None
where the program has no such span or counter."""

import bisect

from harness.preprocess_bytes import pre_process_bytes, share_pct

SPAN = "rwt.pre_process"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemsetAsync", "cudaMemcpyAsync")


def device_us_launched_in(tr, spans) -> float:
    """Summed device time of the operations launched inside ``spans``."""
    launched = sorted(s for s, _, n, _ in tr.host if n.startswith(LAUNCHES))
    ops = sorted((s, t) for _, s, t in tr.device)
    starts = [s for s, _ in ops]
    total = 0.0
    for a, b in spans:
        n = bisect.bisect_left(launched, b) - bisect.bisect_left(launched, a)
        j = bisect.bisect_left(starts, a)
        total += sum(t - s for s, t in ops[j : j + n])
    return total


def read(ctx):
    px = ctx.counters.get("pre_process_px", 0)
    spans = ctx.trace.spans(SPAN)
    if not px or not spans or not ctx.trace.device:
        return None
    return share_pct(pre_process_bytes(px), device_us_launched_in(ctx.trace, spans) / 1e6)
