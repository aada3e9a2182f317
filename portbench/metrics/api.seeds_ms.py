"""api.seeds_ms: median host milliseconds of ``find_local_minima`` in the
traced window (the harness's own span around the call)."""

import statistics


def read(ctx):
    v = ctx.spans.get("api.seeds_ms")
    return statistics.median(v) if v else None
