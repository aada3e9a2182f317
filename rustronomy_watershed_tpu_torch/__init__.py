"""rustronomy_watershed_tpu_torch — the PyTorch + CUDA port of
``rustronomy_watershed_tpu`` for NVIDIA Hopper (H100).

Same builder and transform API as the JAX package, same labels bit for bit.
This package imports torch and numpy and never jax.  Its two hand-written
CUDA kernels (csrc/pack.cu, csrc/relax.cu) are built with nvcc at first use;
CPU tensors run their plain PyTorch twins.  Devices are explicit:
``TransformBuilder.set_device`` (default ``"cuda"``).
"""

from .builder import BuildErr, TransformBuilder
from .constants import ALWAYS_FILL, NEVER_FILL, NORMAL_MAX, UNCOLOURED
from .models import MergingWatershed, SegmentingWatershed, WatershedUtils

__version__ = "0.1.0"

__all__ = [
    "ALWAYS_FILL",
    "NEVER_FILL",
    "NORMAL_MAX",
    "UNCOLOURED",
    "BuildErr",
    "TransformBuilder",
    "MergingWatershed",
    "SegmentingWatershed",
    "WatershedUtils",
    "prelude",
]

from . import prelude  # noqa: E402  (re-export module, mirrors the crate)
