"""Segmenting watershed: lakes never merge; walls form where they meet.

Counterpart of ``rustronomy_watershed_tpu.models.segmenting`` (reference
``SegmentingWatershed``, src/lib.rs:1609-1849).
"""

from __future__ import annotations

from .base import _WatershedBase


class SegmentingWatershed(_WatershedBase):
    _merging = False
