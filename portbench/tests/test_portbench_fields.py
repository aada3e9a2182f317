"""Inputs from the seed repeat exactly; the checked calls are a uniform
sample of the whole window."""

import collections

import numpy as np
import pytest
import torch

from harness import fields, spec
from harness.cell import Reservoir

CELLS = [w["name"] for w in spec.load_bench()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_traffic_from_a_seed_repeats_exactly(name):
    cell = spec.resolve(name)
    shape = (67, 45)  # the generator's own recipe at a small shape
    seed = 2**31 + 12345
    a = fields.make_pool(cell, seed, "cpu", shape)
    b = fields.make_pool(cell, seed, "cpu", shape)
    c = fields.make_pool(cell, seed + 1, "cpu", shape)
    assert len(a) == cell.traffic["pool"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert len({x.numpy().tobytes() for x in a}) == len(a)
    assert all(x.dtype == torch.uint8 and tuple(x.shape) == shape for x in a)


def test_large_seeds_give_distinct_generator_seeds():
    seeds = [0, 1, 2**31, 2**31 + 1, 2**32 + 5, 2**64 - 1, -3]
    got = {fields.image_seed(s, i) for s in seeds for i in range(3)}
    assert len(got) == 3 * len(seeds) and all(0 <= g < 2**63 for g in got)


def test_nan_dots_share():
    cell = spec.resolve("tile4096.merge_nan10")
    img = fields.make_image(cell, (512, 512), cell.traffic["field"], 7, 0, "cpu").numpy()
    share = float((img == 255).mean())
    assert 0.095 < share < 0.105 and img[img != 255].max() <= 253 and img.min() == 0


def test_the_sample_is_uniform_over_the_whole_window():
    hits = collections.Counter()
    for seed in range(2000):
        r = Reservoir(4, 2**33 + seed)
        for n in range(40):
            r.offer(n, n)
        assert len(r.kept) == 4 and len({i for i, _ in r.kept}) == 4 and all(i == a for i, a in r.kept)
        hits.update(i for i, _ in r.kept)
    # each of the 40 calls kept with chance 4/40: 200 of 2000 expected
    assert min(hits[i] for i in range(40)) > 140 and max(hits.values()) < 260
    assert sum(hits[i] for i in range(30, 40)) > 400  # the window's last quarter is checked too


def test_the_sample_repeats_from_the_seed():
    def pick(seed):
        r = Reservoir(2, seed)
        for n in range(500):
            r.offer(n, None)
        return [i for i, _ in r.kept]
    assert pick(2**31 + 7) == pick(2**31 + 7)
    assert np.mean([max(pick(s)) for s in range(50)]) > 250
