"""api.device_curves_ms: median host milliseconds of the program's
``rwt.api.device_curves`` span in the traced window; ``_device_curves``:
pack, the relax fixed point, ``merge_edges`` and the claim-level plane."""

from harness.spans import median_ms


def read(ctx):
    return median_ms(ctx.trace, "rwt.api.device_curves")
