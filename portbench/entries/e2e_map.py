"""Float32 maps resident on the device, quantised there and segmented:
``u8 = ops.pre_process_jnp(map, max_val, device=...)``, then
``ops.watershed_e2e(u8, merging=False, device=...)``, seeds found on the
device, levels and labels left there; a call ends when the device has
finished (``torch.cuda.synchronize()``) and returns ``(u8, labels)``.

Configuration key ``max_val`` (the pre-processor's top level); traffic
key ``reference``, whose ``levels(map, max_val)`` gives the levels and
whose ``segmenting.labels(levels, control=False)`` the labels a call
must return.  Compared, summed over the checked calls (exact counts, limit
0): ``level_mismatch_px``, the program's levels that differ from the
reference quantiser's, and ``label_mismatch_px``, the program's labels
that differ from the reference's labels on the reference's levels (a
missing or misshapen plane counts as all its pixels)."""

import numpy as np
import torch

from rustronomy_watershed_tpu_torch.ops import pre_process_jnp, watershed_e2e


class Entry:
    def __init__(self, cell, device):
        self.max_val = int(cell.config["max_val"])
        self.device = torch.device(device)
        self.reference = lambda: cell.module("reference", cell.traffic["reference"])
        self.spans = {}

    def prepare(self, pool):
        self.inputs = pool

    def call(self, i):
        u8 = pre_process_jnp(self.inputs[i % len(self.inputs)], self.max_val, device=self.device)
        labels = watershed_e2e(u8, merging=False, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return u8, labels

    def to_host(self, out):
        return tuple(t.cpu().numpy() for t in out)

    def control(self, m):
        """The reference put in the program's place, its tie-break broken."""
        ref = self.reference()
        lv = ref.levels(m, self.max_val)
        return lv, ref.segmenting.labels(lv, control=True)

    def compare(self, kept, pool) -> dict:
        """``kept`` = ``[(call index, host answer or None)]``; ``pool`` the
        host maps."""
        ref, want, levels_bad, labels_bad = self.reference(), {}, 0, 0
        for i, out in kept:
            k = i % len(pool)
            if k not in want:
                lv = ref.levels(pool[k], self.max_val)
                want[k] = (lv, ref.segmenting.labels(lv))
            want_lv, want_lab = want[k]
            u8, lab = (None, None) if out is None else out
            levels_bad += _mismatch(u8, want_lv)
            labels_bad += _mismatch(lab, want_lab)
        return {"level_mismatch_px": (levels_bad, 0), "label_mismatch_px": (labels_bad, 0)}


def _mismatch(got, want) -> int:
    if got is None or np.shape(got) != want.shape:
        return int(want.size)
    return int(np.count_nonzero(np.asarray(got) != want))
