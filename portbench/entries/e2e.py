"""``ops.watershed_e2e(img, merging=..., device=...)`` on images resident
on the device, seeds found there, labels left there; a call ends when the
device has finished (``torch.cuda.synchronize()``).

Traffic keys: ``merging`` (bool) and ``reference``, whose ``labels(img,
control=False)`` gives the label plane the call must return.  Compared:
the label pixels that differ from the reference's, summed over the
checked calls (an exact count, limit 0)."""

import numpy as np
import torch

from rustronomy_watershed_tpu_torch.ops import watershed_e2e


class Entry:
    def __init__(self, cell, device):
        self.merging = bool(cell.traffic["merging"])
        self.device = torch.device(device)
        self.reference = lambda: cell.module("reference", cell.traffic["reference"])
        self.spans = {}

    def prepare(self, pool):
        self.inputs = pool

    def call(self, i):
        out = watershed_e2e(self.inputs[i % len(self.inputs)], merging=self.merging, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def to_host(self, out):
        return out.cpu().numpy()

    def control(self, img):
        """The reference put in the program's place, its guarantee broken."""
        return self.reference().labels(img, control=True)

    def compare(self, kept, pool) -> dict:
        """``kept`` = ``[(call index, host answer or None)]``; ``pool`` the
        host images."""
        ref, want, bad = self.reference(), {}, 0
        for i, out in kept:
            k = i % len(pool)
            if k not in want:
                want[k] = ref.labels(pool[k])
            if out is None or np.shape(out) != want[k].shape:
                bad += want[k].size
                continue
            bad += int(np.count_nonzero(np.asarray(out) != want[k]))
        return {"label_mismatch_px": (bad, 0)}
