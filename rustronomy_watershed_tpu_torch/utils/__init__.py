"""Observability utilities: plotting, progress bar, performance report."""

from . import plotting
from .perf import PerfReport
from .progress import ProgressBar

__all__ = ["plotting", "PerfReport", "ProgressBar"]
