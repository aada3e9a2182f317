"""The readers of ``relax.flag_reads`` and ``relax.stopped_calls`` on
made-up windows: the relax fixed point's flag reads and its calls stopped
on the card, a call; nothing where the program has no such counter or ran
no relax call."""

from types import SimpleNamespace

import pytest

from harness import spec
from rustronomy_watershed_tpu_torch import _ext

CELLS = ("tile4096.segment_beam", "tile4096.segment")
COUNTER = {"relax.flag_reads": "relax_reads", "relax.stopped_calls": "relax_stopped"}


def _read(cell, name, counters):
    reader = spec.resolve(cell).readers[name]
    return reader(SimpleNamespace(calls=40, counters=counters, trace=None, spans={}, shape=(4096, 4096)))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", sorted(COUNTER))
@pytest.mark.parametrize("counters, want", [
    ({"relax": 7310, "relax_reads": 1840, "relax_stopped": 180, "host_reads": 1840}, {"relax_reads": 46.0,
                                                                                      "relax_stopped": 4.5}),
    ({"relax": 160, "relax_reads": 40}, {"relax_reads": 1.0, "relax_stopped": 0.0}),
    ({"relax_reads": 40, "relax_stopped": 200}, None),  # no relax launch ran
    ({}, None),
])
def test_a_call_s_reads_and_stopped_calls(cell, name, counters, want):
    got = _read(cell, name, counters)
    assert got == (None if want is None else pytest.approx(want[COUNTER[name]]))


@pytest.mark.parametrize("name", sorted(COUNTER))
def test_a_program_without_the_counter_reads_none(monkeypatch, name):
    """The parent of the blocked fixed point: relax ran, and the program
    has no such counter."""
    monkeypatch.delitem(_ext.launches, COUNTER[name])
    assert _read(CELLS[0], name, {"relax": 7310, "host_reads": 7420}) is None


@pytest.mark.parametrize("name", sorted(COUNTER))
def test_only_the_segmenting_cells_read_them(name):
    assert name not in spec.resolve("tile4096.merge_nan10").readers
    assert name not in spec.resolve("cutout1024.to_list").readers
