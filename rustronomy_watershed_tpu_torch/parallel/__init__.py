"""Multi-device layer: the image tiled over a ``torch.distributed`` device
mesh with halo exchange (counterpart of ``rustronomy_watershed_tpu.parallel``)."""

from .halo import exchange_halo, global_interior_mask
from .tiled import make_mesh, tiled_transform

__all__ = ["exchange_halo", "global_interior_mask", "make_mesh", "tiled_transform"]
