"""The reader of ``api.seed_flat_pct`` on made-up windows: the share of seed
lists read as one flat stream of pairs, and nothing where the program has no
such counter."""

from types import SimpleNamespace

import pytest

from harness import spec

NAME = "api.seed_flat_pct"


def _read(counters):
    reader = spec.resolve("cutout1024.to_list").readers[NAME]
    return reader(SimpleNamespace(calls=24, counters=counters, trace=None, spans={}, shape=(1024, 1024)))


@pytest.mark.parametrize("counters, want", [
    ({"seed_array_flat": 24}, 100.0),
    ({"seed_array_generic": 24, "host_reads": 123}, 0.0),
    ({"seed_array_flat": 18, "seed_array_generic": 6}, 75.0),
    ({"relax": 75, "host_reads": 123}, None),
    ({}, None),
])
def test_flat_share(counters, want):
    got = _read(counters)
    assert got == (want if want is None else pytest.approx(want))


def test_only_the_api_cell_reads_it():
    assert NAME not in spec.resolve("tile4096.merge_nan10").readers
    assert NAME not in spec.resolve("tile4096.segment").readers
