"""api.expand_ms: median host milliseconds of the program's
``rwt.api.expand_rows`` span in the traced window; ``_expand_rows``: the
per-level rows of the result."""

from harness.spans import median_ms


def read(ctx):
    return median_ms(ctx.trace, "rwt.api.expand_rows")
