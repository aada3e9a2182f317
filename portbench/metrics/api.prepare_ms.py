"""api.prepare_ms: median host milliseconds of the program's
``rwt.api.prepare`` span in the traced window; ``_prepare``: the image
copy, ``paint_seeds`` and both host-to-device copies."""

from harness.spans import median_ms


def read(ctx):
    return median_ms(ctx.trace, "rwt.api.prepare")
