"""relax.roofline_all_pct: relax over every launch, the bytes of the pixels
its launches ran at the HBM peak over the device time of every
``relax_kernel`` launch inside the calls' spans.  Bytes: 17 a pixel run
(harness/roofline.py), counted by the port's ``_ext.launches["relax_px_run"]``
(the centre tiles each launch ran, clipped to the plane; a skipped tile
counts 0, and the few bytes it still reads are not credited).  None where
the program has no such counter or no relax launch ran."""

from harness.roofline import relax_bytes, share_pct
from harness.trace import CALL_SPAN


def _is_relax(name):
    return name.startswith("relax_kernel<")


def read(ctx):
    px = ctx.counters.get("relax_px_run", 0)
    if not px:
        return None
    tr = ctx.trace
    calls = [(max(a, tr.lo), min(b, tr.hi)) for a, b in tr.spans(CALL_SPAN)]
    t = sum(min(e, b) - max(s, a) for n, s, e in tr.device if _is_relax(n)
            for a, b in calls if s < b and e > a)
    return share_pct(px * relax_bytes(1, 1), t / 1e6)
