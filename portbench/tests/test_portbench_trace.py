"""The trace reduction and the per-layer readers on made-up events."""

from types import SimpleNamespace

import pytest

from harness import roofline, spec
from harness.trace import CALL_SPAN, WINDOW_SPAN, Trace, busy_us, gaps, merged


def test_busy_us_is_the_union():
    assert busy_us([]) == 0
    assert busy_us([(0, 10)]) == 10
    assert busy_us([(0, 10), (5, 15), (20, 30)]) == 25  # overlap counted once
    assert busy_us([(20, 30), (0, 10), (2, 3)]) == 20  # order and nesting
    assert busy_us([(0, 10), (10, 12)]) == 12
    assert merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    assert gaps([(2, 3), (5, 9)], 0, 10) == [(0, 2), (3, 5), (9, 10)]


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def _trace():
    return Trace([
        _ev(WINDOW_SPAN, "user_annotation", 100, 100),
        _ev(WINDOW_SPAN, "gpu_user_annotation", 100, 100, tid=7),  # not device work
        _ev("portbench.call", "user_annotation", 100, 100),
        _ev("aten::item", "cpu_op", 140, 30),
        _ev("cudaStreamSynchronize", "cuda_runtime", 150, 18),
        _ev("other thread", "cpu_op", 100, 100, tid=2),
        _ev("void (anonymous namespace)::relax_kernel<true, false, false>(unsigned char const*, int)", "kernel", 90, 30, tid=7),
        _ev("void vscan_tiles<true, true, false>(int const*)", "kernel", 130, 10, tid=7),
        _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 138, 4, tid=7),
        _ev("void row_ring<true>(int const*)", "kernel", 190, 20, tid=7),
    ])


def test_trace_window_busy_and_names():
    tr = _trace()
    assert (tr.lo, tr.hi, tr.window_us) == (100, 200, 100)
    # relax 100..120 (clipped), vscan 130..140 with the copy to 142, row_ring 190..200 (clipped)
    assert tr.busy_us == 20 + 12 + 10
    ops = dict(tr.device_ops())
    assert ops["relax_kernel<true, false, false>"] == pytest.approx(20e-6)
    assert ops["Memcpy DtoH"] == pytest.approx(4e-6)
    assert tr.device_us(lambda n: n.startswith("vscan_tiles<true")) == 10


def test_idle_gaps_by_the_host_span_at_their_middle():
    gaps_ = dict(_trace().idle_gaps())
    # gap 120..130 (middle 125: the call), gap 142..190 (middle 166: the synchronise)
    assert gaps_["portbench.call"] == pytest.approx(10e-6)
    assert gaps_["cudaStreamSynchronize"] == pytest.approx(48e-6)
    assert sum(gaps_.values()) == pytest.approx((100 - 42) * 1e-6)


def test_trace_without_a_window_is_refused():
    with pytest.raises(RuntimeError):
        Trace([_ev("k", "kernel", 0, 1)])


@pytest.mark.parametrize("h,w,relax,coarse", [
    (4096, 4096, 4096 * 4096 * 17, 2 * 2048 * 4096 * 4),
    (1024, 1024, 1024 * 1024 * 17, 2 * 512 * 1024 * 4),
    (1023, 1031, 1023 * 1031 * 17, 2 * 512 * 1031 * 4),
])
def test_roofline_byte_counts(h, w, relax, coarse):
    assert roofline.relax_bytes(h, w) == relax
    assert roofline.coarse_round_bytes(h, w) == coarse


def test_share_pct():
    assert roofline.share_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert roofline.share_pct(1, 0) is None and roofline.share_pct(0, 1) is None


def _readers():
    cell = spec.resolve("tile4096.merge_nan10")
    more = spec.resolve("cutout1024.to_list")
    return {**cell.readers, **more.readers}


def test_readers_on_a_made_up_window():
    r = _readers()
    tr = _trace()
    ctx = SimpleNamespace(calls=2, counters={"relax": 8, "coarse_round": 86}, trace=tr, shape=(4096, 4096),
                          spans={"api.seeds_ms": [3.0, 1.0, 2.0], "api.to_list_ms": [10.0]})
    assert r["device.idle_pct"](ctx) == pytest.approx(58.0)
    assert r["driver.relax_calls"](ctx) == 4 and r["driver.tail_rounds"](ctx) == 43
    assert r["relax.roofline_pct"](ctx) is None  # its one relax launch started before the call
    assert r["coarse_round.roofline_pct"](ctx) == pytest.approx(100 * 86 * 2 * 2048 * 4096 * 4 / 3.35e12 / 20e-6)
    assert r["api.seeds_ms"](ctx) == 2.0 and r["api.to_list_ms"](ctx) == 10.0


def test_readers_with_nothing_to_read_return_none():
    r = _readers()
    empty = Trace([_ev(WINDOW_SPAN, "user_annotation", 0, 10)])
    ctx = SimpleNamespace(calls=3, counters={}, trace=empty, shape=(8, 8), spans={})
    assert all(fn(ctx) is None for fn in r.values())


def test_relax_roofline_counts_the_first_launch_of_each_call():
    relax = "void relax_kernel<true, false, false>(unsigned char const*, int)"
    tr = Trace([
        _ev(WINDOW_SPAN, "user_annotation", 0, 1000),
        _ev(CALL_SPAN, "user_annotation", 0, 500),
        _ev(CALL_SPAN, "user_annotation", 500, 500),
        _ev(relax, "kernel", 10, 40, tid=7),   # call 1's first launch: every tile
        _ev(relax, "kernel", 60, 5, tid=7),    # a later launch, quiet tiles skipped: not counted
        _ev("void relax_reduce(int const*)", "kernel", 51, 2, tid=7),
        _ev(relax, "kernel", 520, 60, tid=7),  # call 2's first launch
        _ev(relax, "kernel", 600, 1, tid=7),
    ])
    assert tr.first_in_each(tr.spans(CALL_SPAN), lambda n: n.startswith("relax_kernel<")) == [40, 60]
    ctx = SimpleNamespace(calls=2, counters={"relax": 4}, trace=tr, shape=(4096, 4096), spans={})
    want = 100 * 2 * 4096 * 4096 * 17 / 3.35e12 / 100e-6
    assert _readers()["relax.roofline_pct"](ctx) == pytest.approx(want)
