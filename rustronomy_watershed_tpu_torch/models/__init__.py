"""Transform drivers: segmenting (served) and merging (stub)."""

from .base import WatershedUtils
from .merging import MergingWatershed
from .segmenting import SegmentingWatershed

__all__ = ["WatershedUtils", "MergingWatershed", "SegmentingWatershed"]
