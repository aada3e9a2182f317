"""The bytes the float32 -> u8 pre-processor must move, beside the peak
table of ``harness/roofline.py`` (whose ``share_pct`` is used as it is).

A pixel quantised is its float32 value read once and its u8 level
written once: 5 B, the least that any implementation moves
(``ops/preprocess.py::pre_process_jnp``'s ~20 unfused torch launches
move several times as much)."""

from __future__ import annotations

from .roofline import share_pct

PRE_PROCESS_BYTES_PER_PX = 4 + 1


def pre_process_bytes(px: int) -> int:
    return PRE_PROCESS_BYTES_PER_PX * int(px)


__all__ = ["PRE_PROCESS_BYTES_PER_PX", "pre_process_bytes", "share_pct"]
