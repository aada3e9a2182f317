"""The reader of ``api.curve_block_reuse_pct`` on made-up windows: the share
of pooled-size result blocks of the curve tail taken from the pool, and
nothing where the program has no such counter."""

from types import SimpleNamespace

import pytest

from harness import spec

NAME = "api.curve_block_reuse_pct"


def _read(counters):
    reader = spec.resolve("cutout1024.to_list").readers[NAME]
    return reader(SimpleNamespace(calls=24, counters=counters, trace=None, spans={}, shape=(1024, 1024)))


@pytest.mark.parametrize("counters, want", [
    ({"curve_block_reused": 22, "curve_block_new": 2}, 100 * 22 / 24),
    ({"curve_block_reused": 5}, 100.0),
    ({"curve_block_new": 3, "host_reads": 48}, 0.0),
])
def test_reuse_share(counters, want):
    assert _read(counters) == pytest.approx(want)


def test_a_program_without_the_counters_reads_none():
    assert _read({"relax": 80, "host_reads": 48}) is None
    assert _read({}) is None


def test_only_the_api_cell_reads_it():
    assert NAME not in spec.resolve("tile4096.merge_nan10").readers
    assert NAME not in spec.resolve("tile4096.segment").readers
