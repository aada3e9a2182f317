"""Plain reference of the segmenting watershed: NumPy only.

The reference crate (rustronomy-watershed, src/lib.rs:1379-1438) floods a
u8 image level by level from painted seeds.  Within a level it paints in
rings until nothing changes: in each ring, every uncoloured pixel at or
below the water with a coloured 4-neighbour (as the plane stood after the
ring before) takes a label of those neighbours (src/lib.rs:196-257).  This
module computes exactly that, with the tie-break pinned:

* seeds are the interior pixels whose eight neighbours are all strictly
  below them (src/lib.rs:1178-1197), numbered 1..n in row-major order and
  painted before level 0;
* for each level L = 0..254, in rings to a fixed point, every uncoloured
  interior pixel with ``img <= L`` and a coloured 4-neighbour in the
  previous ring's plane takes the **least** label among its coloured
  4-neighbours (the min-label tie-break; PARITY.md Q2, Q3);
* 255 never floods (``255 <= L`` never holds), and the border ring is
  never painted, since the crate's 3x3 windows never centre on it
  (PARITY.md Q1-Q5).

``rule="max"`` gives the control: the greatest coloured neighbour's label
wins, a broken tie-break guarantee.

How: every pixel waits in the bucket of its value until its level.  A
level's first ring is the pixels of its bucket that touch a lake; each
later ring is the uncoloured neighbours at or below the water of the
pixels the ring before painted, so a ring costs its own pixels, never a
sweep of the plane.  A ring computes all its labels from the plane before
it, then paints them, as the crate's find-then-paint does.

The entries call it through ``labels``, ``seeds`` and ``curve``, the names
``reference/merging.py`` gives; it never imports the code under test.  The
seed rule is ``reference/merging.py``'s, restated here so that this module
needs NumPy alone (that one needs SciPy).
"""

from __future__ import annotations

import numpy as np

NEVER_FILL = 255
LEVELS = 255  # water levels 0..254


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
    return np.argwhere(seed_mask(np.asarray(img, dtype=np.uint8))).astype(np.int64)


def _first_of_each(idx: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """``idx`` without repeats, in linear time: ``pos`` is scratch of the
    plane's size; an index is kept where its last write is its own."""
    at = np.arange(idx.size)
    pos[idx] = at
    return idx[pos[idx] == at]


class Segmenting:
    """The segmenting watershed of one image with its own seeds: each
    pixel's label and the level that painted it."""

    def __init__(self, img: np.ndarray, rule: str = "min"):
        if rule not in ("min", "max"):
            raise ValueError(f"unknown rule {rule!r}")
        self.img = np.asarray(img, dtype=np.uint8)
        h, w = self.img.shape
        mask = seed_mask(self.img)
        self.n_seeds = int(mask.sum())
        self.lab = np.zeros(h * w, dtype=np.int32)
        self.level = np.full(h * w, LEVELS, dtype=np.int16)  # LEVELS: never painted
        flat = np.flatnonzero(mask)
        self.lab[flat] = np.arange(1, flat.size + 1, dtype=np.int32)
        self.level[flat] = 0
        if h >= 3 and w >= 3:
            self._flood(rule)

    def _flood(self, rule: str) -> None:
        img = self.img.reshape(-1)
        h, w = self.img.shape
        lab, level = self.lab, self.level
        interior = np.zeros((h, w), dtype=bool)
        interior[1:-1, 1:-1] = True
        interior = interior.reshape(-1)
        # The buckets: the interior pixels that may flood, by value.
        waiting = np.flatnonzero(interior & (img < NEVER_FILL) & (lab == 0))
        waiting = waiting[np.argsort(img[waiting], kind="stable")]
        edges = np.searchsorted(img[waiting], np.arange(LEVELS + 1))
        steps = np.array([-w, -1, 1, w])
        pos = np.empty(h * w, dtype=np.int64)
        pick = np.minimum if rule == "min" else np.maximum
        none = np.int32(np.iinfo(np.int32).max if rule == "min" else 0)
        for lvl in range(LEVELS):
            ring = waiting[edges[lvl] : edges[lvl + 1]]
            nb = ring[None, :] + steps[:, None]  # interior pixels: every neighbour lies in the plane
            ring = ring[(lab[nb] != 0).any(axis=0)]
            while ring.size:
                nb = ring[None, :] + steps[:, None]
                got = lab[nb]
                got = pick.reduce(np.where(got != 0, got, none), axis=0)
                lab[ring] = got
                level[ring] = lvl
                nb = nb.reshape(-1)
                nb = nb[interior[nb] & (lab[nb] == 0) & (img[nb] <= lvl)]
                ring = _first_of_each(nb, pos)

    def labels(self, level: int = LEVELS - 1) -> np.ndarray:
        """int32 label image after ``level`` (the transform's output)."""
        out = np.where(self.level <= level, self.lab, 0)
        return out.astype(np.int32).reshape(self.img.shape)

    def curve(self, max_water_level: int = LEVELS - 1, counts_length=None) -> np.ndarray:
        """``(max_water_level + 1, counts_length)`` int64: after each level,
        entry 0 the uncoloured pixels, entry k the pixels of label k (the
        reference's find_lake_sizes rows, src/lib.rs:628-635).
        ``counts_length=None``: the reference's ``n_pixels + 1``."""
        n = self.img.size
        width = n + 1 if counts_length is None else int(counts_length)
        if width < self.n_seeds + 1:
            raise ValueError(f"counts_length {width} leaves out labels up to {self.n_seeds}")
        levels, k = max_water_level + 1, self.n_seeds + 1
        painted = self.level < levels
        at = np.bincount(self.level[painted].astype(np.int64) * k + self.lab[painted], minlength=levels * k)
        rows = np.zeros((levels, width), dtype=np.int64)
        rows[:, :k] = np.cumsum(at.reshape(levels, k), axis=0)
        rows[:, 0] = n - rows[:, 1:k].sum(axis=1)
        return rows


def labels(img: np.ndarray, control: bool = False) -> np.ndarray:
    """The label plane of ``watershed_e2e`` (segmenting, seeds from the
    image); ``control=True``: the control's."""
    return Segmenting(img, "max" if control else "min").labels()


def curve(img: np.ndarray, max_water_level: int = LEVELS - 1, control: bool = False, counts_length=None) -> np.ndarray:
    """The per-level lake sizes of ``transform_to_list`` (segmenting, seeds
    from the image), rows of ``counts_length`` entries (None: the
    reference's ``n_pixels + 1``); ``control=True``: the control's."""
    return Segmenting(img, "max" if control else "min").curve(max_water_level, counts_length)
