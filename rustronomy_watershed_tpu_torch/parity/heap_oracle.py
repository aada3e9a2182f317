"""Event-driven (priority-queue) watershed oracle — third independent ground truth.

A copy of ``rustronomy_watershed_tpu.parity.heap_oracle`` (the port imports
nothing of the JAX package).  The package's other two oracles
(parity/oracle.py, parity/oracle.cc) both re-implement the reference's
synchronous level-sweep loop (reference src/lib.rs:1379-1521): level loop
-> Jacobi rings to a fixed point -> merge phase.  A shared misreading of the sweep semantics would pass
between them silently.  This oracle expresses the SAME specification in a
different algorithmic family — Dijkstra-style event-driven claiming on a
binary heap — so agreement pins the semantics, not the implementation:

* pixel p is claimed at key ``(L(p), d(p))``: L = minimax (bottleneck) level
  over 4-paths from a seed, d = Jacobi ring index within the equal-level
  plateau (BFS distance to the sub-level claim that started it);
* popping events in lexicographic key order reproduces the level loop's
  claim order exactly: one ring == one key;
* p's label is the minimum label among 4-neighbours claimed at a strictly
  smaller key (the pinned min-label plateau tie-break, SURVEY.md Q2/Q3);
* the window-centre rule: border pixels are never claimable (but border
  SEEDS are pre-claimed, src/lib.rs:1365-1367);
* merging variant: regions a != b merge at the level where two of their
  pixels first become 4-adjacent and coloured, i.e. ``max(L(p), L(q))``
  (pair detection per level, src/lib.rs:1446-1470), with the pinned
  min-label representative (Q9); pairs of two border pixels are never
  detected (3x3 interior-centre windows).

Pure Python + heapq — slow (use <= 128² fields), but with no shared code or
data layout with the sweep oracles.
"""

from __future__ import annotations

import heapq

import numpy as np

UNCOLOURED = 0
NORMAL_MAX = 254


def heap_transform(
    img,
    seeds,
    max_water_level: int = NORMAL_MAX,
    merging: bool = False,
    edge_correction: bool = False,
    with_sizes: bool = False,
):
    """Labels (and per-level merged/segmented lake-size curves) by event-driven
    claiming.  Mirrors parity.native.native_transform's signature."""
    img = np.asarray(img, dtype=np.uint8)
    if edge_correction:
        img = np.pad(img, 1, constant_values=0)
    h, w = img.shape
    labels = np.zeros((h, w), dtype=np.int64)
    key_l = np.full((h, w), 2**31, dtype=np.int64)  # claim level, INF=never
    key_d = np.full((h, w), 2**31, dtype=np.int64)
    for col, (y, x) in enumerate(seeds, start=1):
        labels[y, x] = col  # Q7: no +1 shift under edge correction
        key_l[y, x] = 0
        key_d[y, x] = 0

    def neighbours(y, x):
        if y > 0:
            yield y - 1, x
        if y < h - 1:
            yield y + 1, x
        if x > 0:
            yield y, x - 1
        if x < w - 1:
            yield y, x + 1

    # Heap of candidate claims (L, d, y, x).  Lazy deletion: stale entries
    # (key already beaten) are skipped at pop.
    heap = []
    for col, (y, x) in enumerate(seeds, start=1):
        for ny, nx in neighbours(y, x):
            _push(heap, img, key_l, ny, nx, 0, 0, h, w, max_water_level)

    while heap:
        lc, dc, y, x = heapq.heappop(heap)
        if (lc, dc) > (key_l[y, x], key_d[y, x]) or labels[y, x] != UNCOLOURED:
            continue  # stale or already claimed
        # claim p: label = min over neighbours with strictly smaller key
        best = None
        for ny, nx in neighbours(y, x):
            if labels[ny, nx] != UNCOLOURED and (
                key_l[ny, nx],
                key_d[ny, nx],
            ) < (lc, dc):
                lab = labels[ny, nx]
                if best is None or lab < best:
                    best = lab
        assert best is not None
        labels[y, x] = best
        key_l[y, x], key_d[y, x] = lc, dc
        for ny, nx in neighbours(y, x):
            _push(heap, img, key_l, ny, nx, lc, dc, h, w, max_water_level)

    # Merging: union-find over pair activations max(L(p), L(q)).
    k = len(seeds)
    if merging or with_sizes:
        parent = np.arange(k + 1, dtype=np.int64)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        pair_edges = []  # (activation level, label a, label b)
        for y in range(h):
            for x in range(w):
                if labels[y, x] == UNCOLOURED:
                    continue
                for ny, nx in ((y + 1, x), (y, x + 1)):
                    if ny >= h or nx >= w or labels[ny, nx] == UNCOLOURED:
                        continue
                    if labels[ny, nx] == labels[y, x]:
                        continue
                    # interior-centre rule: at least one endpoint interior
                    p_int = 0 < y < h - 1 and 0 < x < w - 1
                    q_int = 0 < ny < h - 1 and 0 < nx < w - 1
                    if not (p_int or q_int):
                        continue
                    act = max(key_l[y, x], key_l[ny, nx])
                    pair_edges.append((act, labels[y, x], labels[ny, nx]))
        pair_edges.sort()

    sizes = None
    if with_sizes:
        levels = max_water_level + 1
        sizes = np.zeros((levels, k + 1), dtype=np.int64)
        ei = 0
        for lvl in range(levels):
            if merging:
                while ei < len(pair_edges) and pair_edges[ei][0] == lvl:
                    _, a, b = pair_edges[ei]
                    ra, rb = find(a), find(b)
                    if ra != rb:
                        r = min(ra, rb)
                        parent[ra] = parent[rb] = r
                    ei += 1
            claimed = key_l <= lvl
            labs = labels[claimed]
            if merging:
                labs = np.array([find(a) for a in labs], dtype=np.int64)
            counts = np.bincount(labs, minlength=k + 1)
            sizes[lvl, : len(counts)] = counts
            sizes[lvl, 0] = h * w - claimed.sum()
        # reset parent for the final relabel below (sizes loop consumed it
        # incrementally; by the last level it holds the full union).

    if merging:
        if not with_sizes:
            for _, a, b in pair_edges:
                ra, rb = find(a), find(b)
                if ra != rb:
                    r = min(ra, rb)
                    parent[ra] = parent[rb] = r
        labels = np.array([find(a) for a in labels.reshape(-1)], dtype=np.int64).reshape(
            h, w
        )

    return (labels, sizes) if with_sizes else labels


def _push(heap, img, key_l, y, x, lq, dq, h, w, max_water_level):
    """Push the claim candidate for (y, x) extended from a neighbour claimed
    at (lq, dq).  Border pixels are never claimable (window-centre rule)."""
    if y in (0, h - 1) or x in (0, w - 1):
        return
    lc = max(int(img[y, x]), int(lq))
    if lc > max_water_level:
        return
    dc = dq + 1 if lq == lc else 1
    heapq.heappush(heap, (lc, dc, y, x))


def heap_find_local_minima(img) -> list[tuple[int, int]]:
    """Strict 8-connected local maxima (Q1 semantics), brute force."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    out = []
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            c = img[y, x]
            if all(
                img[y + dy, x + dx] < c
                for dy in (-1, 0, 1)
                for dx in (-1, 0, 1)
                if (dy, dx) != (0, 0)
            ):
                out.append((y, x))
    return out
