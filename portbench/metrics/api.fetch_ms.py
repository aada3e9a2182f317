"""api.fetch_ms: median host milliseconds of the program's
``rwt.api.fetch_planes`` span in the traced window; ``_fetch_planes``:
the one device-to-host copy of the compact planes and the wait for the
queue before it."""

from harness.spans import median_ms


def read(ctx):
    return median_ms(ctx.trace, "rwt.api.fetch_planes")
