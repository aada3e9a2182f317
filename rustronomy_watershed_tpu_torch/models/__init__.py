"""Transform drivers: segmenting and merging."""

from .base import HookCtx, WatershedUtils
from .merging import MergingWatershed
from .segmenting import SegmentingWatershed

__all__ = ["HookCtx", "WatershedUtils", "MergingWatershed", "SegmentingWatershed"]
