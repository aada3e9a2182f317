"""Label / pixel-value conventions of the watershed transforms.

Same values as ``rustronomy_watershed_tpu.constants`` (the reference crate's
public constants, reference src/lib.rs:138-141), plus the packed claim
key layout shared by the pack and relax kernels:

* ``key = L << _D_BITS | d`` — water level ``L`` in the high bits, plateau
  ring index ``d`` in the low ``_D_BITS`` bits;
* ``_UNCLAIMED = NEVER_FILL << _D_BITS`` — level 255, d = 0: larger than any
  claimable key, and its saturating extend still carries level 255, so an
  unclaimed cell never donates a claim (see ops/relax.py).
"""

UNCOLOURED: int = 0
NORMAL_MAX: int = 254
ALWAYS_FILL: int = 0
NEVER_FILL: int = 255

# Sentinel for "no neighbour label"; larger than any possible label.
INT32_MAX: int = 2**31 - 1

# "No label" in the merging scans and statistics: above every label (labels
# stay below 2**24 on the coarse tail), below the packed scan flags
# (rustronomy_watershed_tpu.ops.scan_merge._INF).
_INF: int = 2**29

_D_BITS: int = 23
_D_MASK: int = (1 << _D_BITS) - 1
_UNCLAIMED: int = NEVER_FILL << _D_BITS
