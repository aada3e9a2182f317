"""NaN as scattered dots: each pixel NaN with probability ``nan_frac``
(``bench.py``'s ``BENCH_NANSHAPE=dots``: bad pixels, the adversarial case
for the merging tail's run lengths)."""

import torch


def make(shape, field, gen):
    return torch.rand(shape, generator=gen, device=gen.device) < float(field["nan_frac"])
