"""``find_local_minima`` then ``transform_to_list`` of a built watershed
(``TransformBuilder.default().build_<variant>()``) on host NumPy images,
through the public API; a call ends when the host result is returned.

Traffic keys: ``variant``, ``counts_length`` (null: the reference's
``n_pixels + 1``) and ``reference``, whose ``seeds(img)`` and
``curve(img, max_water_level, control=False)`` give the seed list and the
per-level rows.  Compared, summed over the checked calls (exact counts,
limit 0): seeds missing, extra or misplaced, and row entries that differ
(a missing, misplaced or misshapen row counts as all its entries)."""

import time

import numpy as np
import torch

from rustronomy_watershed_tpu_torch.prelude import TransformBuilder


class Entry:
    def __init__(self, cell, device):
        builder = TransformBuilder.default().set_device(device)
        self.ws = getattr(builder, f"build_{cell.traffic['variant']}")()
        self.counts_length = cell.traffic.get("counts_length")
        self.max_water_level = int(cell.config["max_water_level"])
        self.reference = lambda: cell.module("reference", cell.traffic["reference"])
        self.spans = {"api.seeds_ms": [], "api.to_list_ms": []}

    def prepare(self, pool):
        self.inputs = [p.cpu().numpy() for p in pool]

    def call(self, i):
        img = self.inputs[i % len(self.inputs)]
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.find_local_minima"):
            seeds = self.ws.find_local_minima(img)
        t1 = time.perf_counter()
        with torch.profiler.record_function("portbench.transform_to_list"):
            rows = self.ws.transform_to_list(img, seeds, counts_length=self.counts_length)
        t2 = time.perf_counter()
        self.spans["api.seeds_ms"].append((t1 - t0) * 1e3)
        self.spans["api.to_list_ms"].append((t2 - t1) * 1e3)
        return seeds, rows

    def to_host(self, out):
        return out

    def _width(self, img):
        return self.counts_length or img.size + 1

    def control(self, img):
        """The reference put in the program's place, its guarantee broken."""
        ref = self.reference()
        curve = ref.curve(img, self.max_water_level, control=True)
        rows = np.zeros((curve.shape[0], self._width(img)), dtype=np.int64)
        rows[:, : curve.shape[1]] = curve
        return list(map(tuple, ref.seeds(img).tolist())), list(enumerate(rows))

    def compare(self, kept, pool) -> dict:
        ref, want, seed_bad, curve_bad = self.reference(), {}, 0, 0
        for i, out in kept:
            k = i % len(pool)
            if k not in want:
                want[k] = (ref.seeds(pool[k]), ref.curve(pool[k], self.max_water_level))
            want_seeds, want_curve = want[k]
            if out is None:
                seed_bad += len(want_seeds)
                curve_bad += self._width(pool[k]) * want_curve.shape[0]
                continue
            seeds, rows = out
            got = np.asarray(seeds, dtype=np.int64).reshape(-1, 2)
            n = min(len(got), len(want_seeds))
            seed_bad += abs(len(got) - len(want_seeds)) + int(np.count_nonzero((got[:n] != want_seeds[:n]).any(axis=1)))
            curve_bad += curve_mismatch(rows, want_curve, self._width(pool[k]))
        return {"seed_mismatch": (seed_bad, 0), "curve_mismatch": (curve_bad, 0)}


def curve_mismatch(rows, want, width: int) -> int:
    """Entries of the per-level rows that differ from the reference's;
    a missing, misplaced or misshapen row counts as ``width`` entries.
    Entries past the reference's last label must be 0."""
    levels, k = want.shape
    bad = width * abs(len(rows) - levels)
    for lvl, (got_lvl, row) in enumerate(rows[:levels]):
        row = np.asarray(row)
        if got_lvl != lvl or row.shape != (width,):
            bad += width
            continue
        bad += int(np.count_nonzero(row[:k] != want[lvl])) + int(np.count_nonzero(row[k:]))
    return bad
