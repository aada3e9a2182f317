"""api.transform_ms: median host milliseconds of the program's
``rwt.api.transform`` span in the traced window; the public
``transform``: the image's preparation, the engine to the final labels
and their read back to the host."""

from harness.spans import median_ms


def read(ctx):
    return median_ms(ctx.trace, "rwt.api.transform")
