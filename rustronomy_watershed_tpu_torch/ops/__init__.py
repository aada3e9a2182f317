"""Tensor ops and kernel wrappers: flood sweeps, seeding, merging,
histograms, preprocessing and the level driver.  The same 17 exports as the
JAX package's ``ops``; ``run_levels`` is ``level_driver.run_levels_impl``
(JAX jits it under that name; the port has no jit).  Importing builds no
kernel: the CUDA library is built at the first launch."""

from .flood import flood_sweep, flood_fixed_point
from .seeds import local_extrema_mask, seed_labels_from_mask, paint_seeds
from .merge import merge_touching, resolve_merges, recolour, touching_pairs
from .histogram import lake_sizes, value_histogram
from .preprocess import pre_process, pre_process_jnp
from .level_driver import run_levels_impl as run_levels, level_step
from .pipeline import watershed_e2e, max_seed_count

__all__ = [
    "flood_sweep",
    "flood_fixed_point",
    "local_extrema_mask",
    "seed_labels_from_mask",
    "paint_seeds",
    "merge_touching",
    "resolve_merges",
    "recolour",
    "touching_pairs",
    "lake_sizes",
    "value_histogram",
    "pre_process",
    "pre_process_jnp",
    "run_levels",
    "level_step",
    "watershed_e2e",
    "max_seed_count",
]
