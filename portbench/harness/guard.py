"""The run must not have loaded JAX or the JAX package.

Modules are compared by their top-level name (the part before the first
dot), whole: ``rustronomy_watershed_tpu_torch`` is the port and passes,
``rustronomy_watershed_tpu`` is the JAX package and fails."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rustronomy_watershed_tpu"})


def forbidden_modules(modules) -> list:
    """Sorted top-level names in ``modules`` (e.g. ``sys.modules``) that
    are forbidden."""
    return sorted({m.split(".", 1)[0] for m in modules} & FORBIDDEN)
