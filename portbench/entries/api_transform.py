"""``find_local_minima`` then ``transform`` of a built watershed
(``TransformBuilder.default().set_device(...).build_<variant>()``) on
host NumPy images, through the public API; a call ends when the host
int32 label image is returned.

Traffic keys: ``variant`` and ``reference``, whose ``seeds(img)`` and
``labels(img, control=False)`` give the seed list and the label image.
Compared, summed over the checked calls (exact counts, limit 0): seeds
missing, extra or misplaced (``seed_mismatch``), and label pixels that
differ (``label_mismatch_px``; a missing or misshapen image counts as
all its pixels)."""

import numpy as np

from rustronomy_watershed_tpu_torch.prelude import TransformBuilder


class Entry:
    def __init__(self, cell, device):
        builder = TransformBuilder.default().set_device(device)
        self.ws = getattr(builder, f"build_{cell.traffic['variant']}")()
        self.reference = lambda: cell.module("reference", cell.traffic["reference"])
        self.spans = {}

    def prepare(self, pool):
        self.inputs = [p.cpu().numpy() for p in pool]

    def call(self, i):
        img = self.inputs[i % len(self.inputs)]
        seeds = self.ws.find_local_minima(img)
        return seeds, self.ws.transform(img, seeds)

    def to_host(self, out):
        return out

    def control(self, img):
        """The reference put in the program's place, its tie-break broken."""
        ref = self.reference()
        return list(map(tuple, ref.seeds(img).tolist())), ref.labels(img, control=True)

    def compare(self, kept, pool) -> dict:
        ref, want, seed_bad, label_bad = self.reference(), {}, 0, 0
        for i, out in kept:
            k = i % len(pool)
            if k not in want:
                want[k] = (ref.seeds(pool[k]), ref.labels(pool[k]))
            want_seeds, want_labels = want[k]
            if out is None:
                seed_bad += len(want_seeds)
                label_bad += want_labels.size
                continue
            seeds, labels = out
            got = np.asarray(seeds, dtype=np.int64).reshape(-1, 2)
            n = min(len(got), len(want_seeds))
            seed_bad += abs(len(got) - len(want_seeds)) + int(np.count_nonzero((got[:n] != want_seeds[:n]).any(axis=1)))
            if np.shape(labels) != want_labels.shape:
                label_bad += want_labels.size
            else:
                label_bad += int(np.count_nonzero(np.asarray(labels) != want_labels))
        return {"seed_mismatch": (seed_bad, 0), "label_mismatch_px": (label_bad, 0)}
