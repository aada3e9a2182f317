"""api.curve_tail_ms: median host milliseconds of the program's
``rwt.api.curve_tail`` span in the traced window; ``merged_curve_host``:
the native C++ curve pass and its result block."""

from harness.spans import median_ms


def read(ctx):
    return median_ms(ctx.trace, "rwt.api.curve_tail")
