"""Per-level performance report of the debug mode.

Counterpart of ``rustronomy_watershed_tpu.utils.perf`` and the reference's
``debug`` cargo feature (reference src/lib.rs:640-696,
``performance_monitoring::PerfReport``): per-level candidate-search and
paint times, loop count, merge and histogram times, and a summary with the
computed overhead.  Enabled by ``TransformBuilder.enable_debug()``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PerfReport:
    big_iter_ms: list[int] = dataclasses.field(default_factory=list)
    colouring_mus: list[int] = dataclasses.field(default_factory=list)
    loops: int = 0
    merge_ms: int = 0
    lake_count_ms: int = 0
    total_ms: int = 0

    def iter_avg(self) -> float:
        n = len(self.big_iter_ms)
        return sum(self.big_iter_ms) / n if n else float("nan")

    def iter_total(self) -> float:
        return float(sum(self.big_iter_ms))

    def colour_avg(self) -> float:
        n = len(self.big_iter_ms)
        return sum(self.colouring_mus) / n if n else float("nan")

    def colour_total(self) -> float:
        return float(sum(self.colouring_mus))

    def __str__(self) -> str:
        overhead = (
            self.total_ms
            - self.iter_total()
            - self.colour_total() / 1000.0
            - self.merge_ms
            - self.lake_count_ms
        )
        return (
            ">---------[Performance Summary]---------\n"
            f">  Looped {self.loops}x\n"
            f">  Iteration Average: {self.iter_avg():.1f}ms; Σ {self.iter_total():.0f}ms\n"
            f">  Colouring Average: {self.colour_avg():.1f}µs; Σ {self.colour_total():.0f}µs\n"
            f">  Merging: {self.merge_ms}ms\n"
            f">  Counting Lakes: {self.lake_count_ms}ms\n"
            ">--------------------------------+ total\n"
            f">  {self.total_ms}ms with {overhead:.1f}ms overhead (Δt)\n"
        )
