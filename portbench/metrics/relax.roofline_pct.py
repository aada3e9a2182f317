"""relax.roofline_pct: the first relax launch of each call, its bytes at
the HBM peak over its device time in the trace.  Only the first launch of
a fixed point is counted: it runs every tile, so it moves its 17 B a
pixel of the image's shape (harness/roofline.py), while a later launch
skips the quiet tiles and moves bytes no counter reports yet."""

from harness.roofline import relax_bytes, share_pct
from harness.trace import CALL_SPAN


def _is_relax(name):
    return name.startswith("relax_kernel<")


def read(ctx):
    first = ctx.trace.first_in_each(ctx.trace.spans(CALL_SPAN), _is_relax)
    if not first:
        return None
    return share_pct(len(first) * relax_bytes(*ctx.shape), sum(first) / 1e6)
