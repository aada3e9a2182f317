"""Plain reference of the merging watershed: NumPy and SciPy only.

The reference crate (rustronomy-watershed, src/lib.rs:1328-1522) floods a
u8 image level by level from painted seeds and, in its merging variant,
merges every pair of touching lakes after each level, the least label
winning (pinned by the min-label tie-break).  Whatever order the pixels of
a level are claimed in, the state after level L is then fixed by two
facts:

* the claimed set C_L is every pixel of ``interior & (img <= L | seed)``
  that is 4-connected inside that mask to a seed (a pixel floods when it is
  an interior pixel at or below the water and 4-adjacent to a lake;
  src/lib.rs:196-257; 255 never floods, but a painted seed is a lake);
* every 4-connected component of C_L is one lake, labelled with the least
  seed label inside it (touching lakes merge, src/lib.rs:1446-1466).

Seeds are the interior pixels whose eight neighbours are all strictly
below them (src/lib.rs:1178-1197, the "local minima" that are maxima),
numbered 1..n in row-major order.  This module computes those sets with
``scipy.ndimage.label`` and never imports the code under test.

``rule="max"`` gives the control: the same lakes labelled with their
greatest seed label, a broken tie-break guarantee.

The entries call it through ``labels``, ``seeds`` and ``curve``; a
reference of other semantics (segmenting) gives the same three by name.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

NEVER_FILL = 255


def seed_mask(img: np.ndarray) -> np.ndarray:
    """Interior pixels strictly above all eight neighbours."""
    h, w = img.shape
    ok = np.zeros((h, w), dtype=bool)
    if h < 3 or w < 3:
        return ok
    c = img[1:-1, 1:-1]
    inner = np.ones(c.shape, dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                inner &= img[1 + dy : h - 1 + dy, 1 + dx : w - 1 + dx] < c
    ok[1:-1, 1:-1] = inner
    return ok


def seeds(img: np.ndarray) -> np.ndarray:
    """``(n, 2)`` int64 seed coordinates in row-major order."""
    return np.argwhere(seed_mask(img)).astype(np.int64)


class Merging:
    """The merging watershed of one image with its own seeds."""

    def __init__(self, img: np.ndarray, rule: str = "min"):
        if rule not in ("min", "max"):
            raise ValueError(f"unknown rule {rule!r}")
        self.img = np.asarray(img, dtype=np.uint8)
        self.rule = rule
        self.mask = seed_mask(self.img)
        self.n_seeds = int(self.mask.sum())
        h, w = self.img.shape
        self.interior = np.zeros((h, w), dtype=bool)
        self.interior[1:-1, 1:-1] = True
        flat = np.flatnonzero(self.mask)
        self._seed_flat = flat
        self._seed_label = np.arange(1, flat.size + 1, dtype=np.int64)

    def _lakes(self, level: int):
        """``(component image, label of each component)``; label 0 marks a
        component with no seed (unclaimed)."""
        m = self.interior & ((self.img <= level) | self.mask)
        comp, nc = ndimage.label(m)
        comp = comp.reshape(-1)
        owner = comp[self._seed_flat]
        lab = np.zeros(nc + 1, dtype=np.int64)
        if self.rule == "min":
            lab[:] = np.iinfo(np.int64).max
            np.minimum.at(lab, owner, self._seed_label)
            lab[lab == np.iinfo(np.int64).max] = 0
        else:
            np.maximum.at(lab, owner, self._seed_label)
        lab[0] = 0
        return comp, lab

    def labels(self, level: int = 254) -> np.ndarray:
        """int32 label image after ``level`` (the transform's output)."""
        comp, lab = self._lakes(level)
        return lab[comp].astype(np.int32).reshape(self.img.shape)

    def sizes(self, level: int) -> np.ndarray:
        """``(n_seeds + 1,)`` int64 lake sizes after ``level``; entry 0 is
        the uncoloured count (the reference's find_lake_sizes row,
        src/lib.rs:628-635, up to the last seed label)."""
        comp, lab = self._lakes(level)
        counts = np.bincount(comp, minlength=lab.size)
        row = np.zeros(self.n_seeds + 1, dtype=np.int64)
        owned = lab > 0
        row[lab[owned]] = counts[owned]
        row[0] = self.img.size - row[1:].sum()
        return row

    def curve(self, max_water_level: int = 254) -> np.ndarray:
        """``(max_water_level + 1, n_seeds + 1)`` int64: ``sizes`` of every
        level."""
        return np.stack([self.sizes(lvl) for lvl in range(max_water_level + 1)])


def labels(img: np.ndarray, control: bool = False) -> np.ndarray:
    """The label plane of ``watershed_e2e`` (merging, seeds from the
    image); ``control=True``: the control's."""
    return Merging(img, "max" if control else "min").labels()


def curve(img: np.ndarray, max_water_level: int = 254, control: bool = False) -> np.ndarray:
    """The per-level lake sizes of ``transform_to_list`` (merging, seeds
    from the image); ``control=True``: the control's."""
    return Merging(img, "max" if control else "min").curve(max_water_level)
