"""The segmenting cell ``tile4096.segment`` on the CPU at a small size: it
resolves, its pool repeats from the seed, a run is correct, each fault
that a segmenting path can have makes ``correct`` false, the control
fails the comparison, and its two per-layer readers on made-up windows."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from control import control_reading
from harness import fields, spec
from harness.cell import run_cell
from harness.trace import CALL_SPAN, WINDOW_SPAN, Trace
from reference import segmenting

NAME = "tile4096.segment"
SMALL = (96, 80)
SEED = 2**31 + 91


def small():
    cell = spec.resolve(NAME)
    cell.config = dict(cell.config, shape=list(SMALL))
    return cell


def run_small(trace=False):
    return run_cell(small(), seed=SEED, seconds=0.05, trace=trace, device="cpu")


def test_the_cell_resolves():
    cell = spec.resolve(NAME)
    assert cell.chips == 1 and cell.config["name"] == "segment4096_u8" and cell.config["shape"] == [4096, 4096]
    assert cell.config["reduced"] == []
    assert cell.traffic["merging"] is False and cell.traffic["reference"] == "segmenting"
    assert cell.traffic["pool"] == 4 and cell.traffic["check"]["sample"] == 4 and cell.traffic["trace_calls"] == 200
    assert cell.traffic["field"] == {"kind": "uniform", "high": 254, "nan_frac": 0.0}
    assert [m["name"] for m in cell.end_to_end] == ["mpix_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["relax.roofline_all_pct", "relax.sweeps"]
    assert callable(cell.module("reference", "segmenting").labels)


def test_the_pool_repeats_from_the_seed():
    cell = spec.resolve(NAME)
    a = fields.make_pool(cell, SEED, "cpu", (131, 77))
    b = fields.make_pool(cell, SEED, "cpu", (131, 77))
    c = fields.make_pool(cell, SEED + 1, "cpu", (131, 77))
    assert len(a) == 4 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert len({x.numpy().tobytes() for x in a}) == 4
    assert all(int(x.max()) <= 253 and x.dtype == torch.uint8 for x in a)  # uniform 0..253, no NEVER_FILL


def test_a_run_is_correct():
    r = run_small()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 4
    assert set(r["metrics"]) == {"mpix_per_s", "setup_s"}
    assert r["compared"] == {"label_mismatch_px": {"value": 0, "limit": 0}}


def test_a_traced_run_on_the_cpu_reads_no_device_metric():
    r = run_small(trace=True)
    assert r["correct"] is True and "busy_s" in r["device"]
    assert set(r["metrics"]) <= {"relax.roofline_all_pct", "relax.sweeps"}
    assert "relax.roofline_all_pct" not in r["metrics"]  # the CPU twins launch no relax kernel


# -- faults planted under the timed path: each must make `correct` false ----


def _seed_dropped(real):
    """The first seed left out: its lake goes to its neighbours."""
    def call(self, i):
        from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

        img = self.inputs[i % len(self.inputs)].numpy()
        ws = TransformBuilder.default().set_device("cpu").build_segmenting()
        return torch.from_numpy(np.asarray(ws.transform(img, ws.find_local_minima(img)[1:])))
    return call


def _max_label(real):
    """The greatest coloured neighbour's label wins a tie."""
    def call(self, i):
        return torch.from_numpy(segmenting.labels(self.inputs[i % len(self.inputs)].numpy(), control=True))
    return call


def _pixel_uncoloured(real):
    """One painted pixel left uncoloured."""
    def call(self, i):
        out = real(self, i).clone()
        out[out.shape[0] // 2, out.shape[1] // 2] = 0
        return out
    return call


@pytest.mark.parametrize("fault", [_seed_dropped, _max_label, _pixel_uncoloured])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    cls = spec.resolve(NAME).module("entries", "e2e").Entry
    monkeypatch.setattr(cls, "call", fault(cls.call))
    r = run_small()
    assert r["correct"] is False
    assert r["compared"]["label_mismatch_px"]["value"] > 0


def test_control_fails_the_comparison():
    compared = control_reading(small(), SEED, "cpu")
    assert 0 < compared["label_mismatch_px"] < 4 * SMALL[0] * SMALL[1]


# -- the two readers on made-up windows ---------------------------------------


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


RELAX = "void (anonymous namespace)::relax_kernel<false, false, false>(unsigned char const*, int)"


def _trace():
    return Trace([
        _ev(WINDOW_SPAN, "user_annotation", 0, 1000),
        _ev(CALL_SPAN, "user_annotation", 0, 400),
        _ev(CALL_SPAN, "user_annotation", 500, 400),
        _ev(RELAX, "kernel", 10, 40, tid=7),   # call 1: a launch that runs every tile
        _ev(RELAX, "kernel", 60, 10, tid=7),   # and one that skips most
        _ev("void relax_reduce(int const*)", "kernel", 51, 2, tid=7),  # not relax's sweeps
        _ev("void pack_bands<true>(unsigned char const*)", "kernel", 2, 5, tid=7),
        _ev(RELAX, "kernel", 520, 40, tid=7),  # call 2
        _ev(RELAX, "kernel", 570, 10, tid=7),
        _ev(RELAX, "kernel", 950, 30, tid=7),  # between calls: not a call's
    ])


def _readers():
    return spec.resolve(NAME).readers


def test_relax_roofline_over_every_launch():
    px = 4096 * 4096 + 1000 * 1000  # at 100 us: 90% of the bound
    ctx = SimpleNamespace(calls=2, counters={"relax_px_run": px, "relax_sweeps": 32}, trace=_trace(),
                          shape=(4096, 4096), spans={})
    want = 100 * px * 17 / 3.35e12 / 100e-6
    assert _readers()["relax.roofline_all_pct"](ctx) == pytest.approx(want)
    assert _readers()["relax.sweeps"](ctx) == 16


def test_the_readers_on_a_program_without_the_counters():
    """The parent's program counts neither: both readers return None, and
    raise nothing."""
    ctx = SimpleNamespace(calls=2, counters={"relax": 4, "relax_tiles": 800}, trace=_trace(), shape=(4096, 4096),
                          spans={})
    assert all(fn(ctx) is None for fn in _readers().values())
