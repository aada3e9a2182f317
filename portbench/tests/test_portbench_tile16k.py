"""The 16384² merging cell ``tile16384.merge_nan10`` on the CPU: it
resolves with its three per-layer metrics, a run at a small size forced
onto the fine scan tail (a label bound of 2**24, as every square tile of
8193² or more has) is correct and counts the tail's rounds, the control
fails the comparison, the readers on made-up windows and on a program
without the fine tail's span and counters, and the fine pass's bytes."""

import re
from types import SimpleNamespace

import pytest

from control import control_reading
from harness import spec
from harness.cell import run_cell
from harness.fine_round_bytes import fine_pass_bytes
from harness.trace import CALL_SPAN, WINDOW_SPAN, Trace

NAME = "tile16384.merge_nan10"
METRICS = ["fine_tail.rounds", "fine_tail.idle_ms", "fine_round.roofline_pct"]
SMALL = (96, 80)
SEED = 2**31 + 161


def small():
    cell = spec.resolve(NAME)
    cell.config = dict(cell.config, shape=list(SMALL))
    return cell


@pytest.fixture
def fine_route(monkeypatch):
    """The label bound of a 16384² tile at the small size: the coarse gate
    fails as it does on the cell's tiles."""
    from rustronomy_watershed_tpu_torch.ops import pipeline

    monkeypatch.setattr(pipeline, "max_seed_count", lambda shape: 1 << 24)


def test_the_cell_resolves():
    cell = spec.resolve(NAME)
    assert cell.chips == 1 and cell.config["name"] == "tile16384_u8" and cell.config["shape"] == [16384, 16384]
    assert cell.config["reduced"] == [] and cell.config["dtype"] == "uint8" and cell.config["max_water_level"] == 254
    assert cell.traffic["entry"] == "e2e" and cell.traffic["merging"] is True and cell.traffic["reference"] == "merging"
    assert cell.traffic["pool"] == 2 and cell.traffic["check"]["sample"] == 2 and cell.traffic["trace_calls"] == 16
    assert cell.traffic["field"] == {"kind": "uniform", "high": 254, "nan_frac": 0.1, "nan_layout": "dots"}
    assert [m["name"] for m in cell.end_to_end] == ["mpix_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == METRICS


def test_the_cells_tiles_take_the_fine_tail():
    from rustronomy_watershed_tpu_torch.ops.pipeline import max_seed_count
    from rustronomy_watershed_tpu_torch.ops.scan_merge import _coarse_gate

    assert max_seed_count((16384, 16384)) == 67_092_481
    assert not _coarse_gate(16384, max_seed_count((16384, 16384)))
    assert not _coarse_gate(8193, max_seed_count((8193, 8193))) and _coarse_gate(8192, max_seed_count((8192, 8192)))


def test_a_run_on_the_fine_tail_is_correct(fine_route):
    r = run_cell(small(), seed=SEED, seconds=0.05, trace=False, device="cpu")
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"mpix_per_s", "setup_s"}
    assert r["compared"] == {"label_mismatch_px": {"value": 0, "limit": 0}}


def test_a_traced_run_on_the_cpu_reads_the_rounds_only(fine_route):
    r = run_cell(small(), seed=SEED, seconds=0.05, trace=True, device="cpu")
    assert r["correct"] is True and "busy_s" in r["device"]
    assert set(r["metrics"]) == {"fine_tail.rounds"}  # no device kernel and no device time on the CPU
    assert r["metrics"]["fine_tail.rounds"]["value"] >= 1


def test_control_fails_the_comparison():
    compared = control_reading(small(), SEED, "cpu")
    assert 0 < compared["label_mismatch_px"] < 2 * SMALL[0] * SMALL[1]


# -- the three readers on made-up windows -------------------------------------


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def _k(name, ts, dur):
    return _ev(name, "kernel", ts, dur, tid=7)


FWD = "void vscan_tiles<false, true, true>(int const*, int*, int*, int*, int*, int, int, int, int const*, int const*, int*)"
BWD = "void vscan_tiles<false, true, false>(int const*, int*, int*, int*, int*, int, int, int, int const*, int const*, int*)"
RING = "void row_ring<false>(int const*, int*, int*, int, int, int, int, int const*)"
COARSE = "void vscan_tiles<true, true, true>(int const*, int*, int*, int*, int*, int, int, int, int const*, int const*, int*)"
FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>>(int, float)"


def _trace(spans=True):
    """Two calls.  In each, ``rwt.tail`` (100-400 after the call's start)
    holds ``rwt.tail.fine`` (110-390), in which two rounds run: fwd_v 10 us,
    bwd_vh's column scan 20 and row kernel 15, with a flag fill and a
    memset between them, and the card idle 30 us after each round (the
    host's flag read); a coarse column scan runs before the tail, and one fine kernel
    outside the span (a direct call) is left out."""
    ev = [_ev(WINDOW_SPAN, "user_annotation", 0, 2000)]
    for c in (0, 1000):
        ev += [_ev(CALL_SPAN, "user_annotation", c, 900), _ev("rwt.tail", "user_annotation", c + 100, 300),
               _k(COARSE, c + 20, 50)]
        if spans:
            ev.append(_ev("rwt.tail.fine", "user_annotation", c + 110, 280))
        t = c + 120
        for _ in range(2):
            ev += [_k(FILL, t, 2), _k(FWD, t + 2, 10), _ev("Memset (Device)", "gpu_memset", t + 12, 3, tid=7),
                   _k(BWD, t + 15, 20), _k(RING, t + 35, 15),
                   _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", t + 50, 5, tid=7)]
            t += 55 + 30  # the round, then the host's flag read with the card idle
        ev.append(_k(RING, c + 950, 40))
    return Trace(ev)


def _ctx(tr, counters):
    return SimpleNamespace(calls=2, counters=counters, trace=tr, shape=(16384, 16384), spans={})


COUNTERS = {"fwd_v": 4, "bwd_vh": 4, "fine_tail": 2, "fine_round": 4, "host_reads": 6}


def _readers():
    return spec.resolve(NAME).readers


def test_fine_tail_rounds_a_call():
    assert _readers()["fine_tail.rounds"](_ctx(_trace(), COUNTERS)) == 2.0


def test_fine_tail_idle_under_the_fine_span():
    # each call: 110-120 before the first round, 175-205 between the rounds,
    # and 260-390, from the second round's flag copy to the span's end
    assert _readers()["fine_tail.idle_ms"](_ctx(_trace(), COUNTERS)) == pytest.approx((10 + 30 + 130) / 1e3)


def test_fine_round_roofline_over_the_passes_in_the_span():
    px = 16384 * 16384
    device_s = 2 * 2 * (10 + 20 + 15) / 1e6  # 2 calls x 2 rounds; fills, sets, copies and the outside launch left out
    want = 100 * 8 * px * 8 / 3.35e12 / device_s
    assert _readers()["fine_round.roofline_pct"](_ctx(_trace(), COUNTERS)) == pytest.approx(want)


def test_the_readers_on_a_program_without_the_span_and_counters():
    """The parent's program has neither the span nor the two counters: it
    counts its fine passes' launches, and each reader returns None and
    raises nothing."""
    ctx = _ctx(_trace(spans=False), {"fwd_v": 4, "bwd_vh": 4, "host_reads": 6, "merge_tail": 2})
    readers = _readers()
    assert len(readers) == 3 and all(fn(ctx) is None for fn in readers.values())


def test_the_fine_pass_bytes_are_chip_smokes():
    assert fine_pass_bytes(16384, 16384) == 16384 * 16384 * 8 == 2_147_483_648
    src = (spec.ROOT / "chip_smoke.py").read_text()
    bounds = dict(re.findall(r'"(fwd_v|bwd_vh)": bound\(px16 \* (\d+),', src))
    assert bounds == {"fwd_v": "8", "bwd_vh": "8"}
