"""fine_round.roofline_pct: the fine scan tail's passes at the HBM peak.

Bytes: 8 a pixel a pass (``harness/fine_round_bytes.py``) for every
``fwd_v`` and ``bwd_vh`` launch of the window (the port's
``_ext.launches["fwd_v"]`` and ``["bwd_vh"]``).  Time: the device time of
the fine passes' kernels inside the program's ``rwt.tail.fine`` spans,
which end with a blocking read of the last round's flag, so every kernel
the span launched has run inside it.  The kernels, as the trace prints
them: the fine column scans ``vscan_tiles<false, ...>`` (forward and
backward), the ring row kernel ``row_ring<false>``, and for rows over the
ring's width ``run_min_pass<false>`` and ``violations<false>``.  The flag
fills, the look-back status fills and the flag copies are left out.  None
where the program has no such span or no fine pass ran."""

from harness.fine_round_bytes import fine_pass_bytes, share_pct

SPAN = "rwt.tail.fine"
KERNELS = ("vscan_tiles<false", "row_ring<false>", "run_min_pass<false>", "violations<false>")


def read(ctx):
    passes = ctx.counters.get("fwd_v", 0) + ctx.counters.get("bwd_vh", 0)
    tr = ctx.trace
    spans = [(max(a, tr.lo), min(b, tr.hi)) for a, b in tr.spans(SPAN)]
    if not passes or not spans:
        return None
    t = sum(min(e, b) - max(s, a) for n, s, e in tr.device if n.startswith(KERNELS)
            for a, b in spans if s < b and e > a)
    return share_pct(passes * fine_pass_bytes(*ctx.shape), t / 1e6)
