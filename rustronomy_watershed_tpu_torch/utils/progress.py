"""Terminal progress bar for the level sweep.

Counterpart of ``rustronomy_watershed_tpu.utils.progress`` and the
reference's ``progress`` cargo feature (indicatif bar, reference
src/lib.rs:160-167): spinner, [elapsed/estimated], "water level pos/len"
and a 60-character bar, written to stderr.  Enabled by
``TransformBuilder.enable_progress()``.
"""

from __future__ import annotations

import sys
import time

_SPINNER = "|/-\\"


class ProgressBar:
    def __init__(self, total: int, width: int = 60, stream=None):
        self.total = max(1, int(total))
        self.pos = 0
        self.width = width
        self.start = time.monotonic()
        self.ticks = 0
        self.stream = stream or sys.stderr

    def _fmt_t(self, seconds: float) -> str:
        m, s = divmod(int(seconds), 60)
        return f"{m:02d}:{s:02d}"

    def _render(self):
        elapsed = time.monotonic() - self.start
        eta = elapsed * self.total / self.pos if self.pos else 0.0
        filled = self.width * self.pos // self.total
        bar = "#" * filled + "-" * (self.width - filled)
        spin = _SPINNER[self.ticks % len(_SPINNER)]
        self.stream.write(
            f"\r{spin}[{self._fmt_t(elapsed)}/{self._fmt_t(eta)}] "
            f"water level {self.pos}/{self.total}{bar}"
        )
        self.stream.flush()

    def tick(self):
        self.ticks += 1
        self._render()

    def inc(self, n: int = 1):
        self.pos = min(self.total, self.pos + n)
        self._render()

    def finish(self):
        self._render()
        self.stream.write("\n")
        self.stream.flush()
