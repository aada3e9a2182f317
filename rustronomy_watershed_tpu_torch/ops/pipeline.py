"""End-to-end watershed with seeds from the image.

Counterpart of ``rustronomy_watershed_tpu.ops.pipeline`` with
``backend='relax_pallas'``: the pack kernel finds and numbers the seeds
(reference ``find_local_minima`` order) and writes the packed planes, the
relax kernel runs to the fixed point, and for merging the component-min
stage follows (ops/level_driver.py).  The seed coordinate list never reaches
the host.
"""

from __future__ import annotations

from .level_driver import run_levels_impl


def max_seed_count(shape: tuple[int, int]) -> int:
    """Upper bound on the number of seeds: strict 8-connected local maxima
    are pairwise non-adjacent, so at most ceil((H-2)/2) * ceil((W-2)/2)
    interior pixels qualify."""
    h, w = shape
    return max(1, ((h - 1) // 2) * ((w - 1) // 2))


def watershed_e2e(
    img,
    *,
    max_water_level: int = 254,
    merging: bool = False,
    collect: str = "none",
    steps: int | None = None,
    with_flags: bool = False,
    device="cuda",
):
    """Seeds from the image, then the full transform on the packed engine.
    Returns what run_levels_impl returns.  The seed count is known only on
    the device, so the labels are bounded by ``max_seed_count``
    (pipeline.py:54-55)."""
    return run_levels_impl(
        img,
        None,
        max_water_level=max_water_level,
        merging=merging,
        n_labels=max_seed_count(tuple(img.shape)),
        collect=collect,
        backend="packed",
        steps=steps,
        with_flags=with_flags,
        device=device,
    )
