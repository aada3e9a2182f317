"""The bytes a pass of the fine scan tail must move, beside the peak
table of ``harness/roofline.py`` (whose ``share_pct`` is used as it is).

A fine pass (``fwd_v``, or ``bwd_vh``: its column scan and its row
kernel together) is the int32 label plane read once and written once:
8 B a pixel, ``chip_smoke.py``'s ``bound(px16 * 8, ...)`` for each pass.
``bwd_vh`` moves the plane twice (the column scan into a scratch plane,
then the row kernel back), so the count credits no byte that is not
moved."""

from __future__ import annotations

from .roofline import share_pct

FINE_PASS_BYTES_PER_PX = 4 + 4


def fine_pass_bytes(h: int, w: int) -> int:
    return FINE_PASS_BYTES_PER_PX * int(h) * int(w)


__all__ = ["FINE_PASS_BYTES_PER_PX", "fine_pass_bytes", "share_pct"]
