"""api.to_list_ms: median host milliseconds of ``transform_to_list`` in the
traced window (the harness's own span around the call)."""

import statistics


def read(ctx):
    v = ctx.spans.get("api.to_list_ms")
    return statistics.median(v) if v else None
