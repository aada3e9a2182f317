"""The program's own spans in a traced window: the ``rwt.*`` ranges that
``rustronomy_watershed_tpu_torch.utils.tracing.span`` opens at each layer
boundary while a profiler session is active.  A reader returns None when
the program opened no span of the name (a program without them)."""

from __future__ import annotations

import statistics

from .trace import gaps, merged


def median_ms(tr, name: str):
    """Median duration (ms) of the spans ``name`` on the window's thread."""
    d = [(e - s) / 1e3 for s, e in tr.spans(name)]
    return statistics.median(d) if d else None


def overlap_us(a, b) -> float:
    """Summed overlap of two lists of disjoint sorted ``(start, end)``
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_per_call(ctx, name: str):
    """Device-idle ms a call that lie under a span ``name``: the window's
    idle gaps (no kernel, copy or set on the device) intersected with the
    union of the spans, whatever spans enclose them.  None without a device
    interval in the trace (a session that saw no device)."""
    tr = ctx.trace
    spans = tr.spans(name)
    if not spans or not ctx.calls or not tr.device:
        return None
    return overlap_us(gaps(tr.busy, tr.lo, tr.hi), merged(spans)) / 1e3 / ctx.calls
