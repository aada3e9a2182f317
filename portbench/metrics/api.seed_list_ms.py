"""api.seed_list_ms: median host milliseconds of the program's
``rwt.api.seed_list`` span in the traced window; the seed list of
``find_local_minima`` (``torch.nonzero`` and its read into Python
tuples)."""

from harness.spans import median_ms


def read(ctx):
    return median_ms(ctx.trace, "rwt.api.seed_list")
