"""The readers of the program's own spans and counters (harness/spans.py,
``metrics/api.*_ms``, ``driver.idle_ms``, ``tail.idle_ms``,
``driver.host_reads``, ``relax.tiles_run_pct``) on made-up windows."""

from types import SimpleNamespace

import pytest

from harness import spec
from harness.spans import idle_ms_per_call, median_ms, overlap_us
from harness.trace import CALL_SPAN, WINDOW_SPAN, Trace

NEW = ("api.seed_list_ms", "api.prepare_ms", "api.device_curves_ms", "api.fetch_ms", "api.curve_tail_ms",
       "api.expand_ms", "driver.idle_ms", "tail.idle_ms", "driver.host_reads", "relax.tiles_run_pct")


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def _host(name, ts, dur):
    return _ev(name, "user_annotation", ts, dur)


def _kernel(ts, dur):
    return _ev("void relax_kernel<true, false, false>(unsigned char const*, int)", "kernel", ts, dur, tid=7)


def _window():
    return Trace(_window_events())


def _window_events():
    """Two calls: an e2e call (the relax span two deep, then the tail) and
    an API call (the relax span three deep).  Device busy 25-100, 120-150,
    210-400, 540-640; idle 0-25, 100-120, 150-210 (across the relax span's
    end at 200), 400-540 and 640-1000."""
    return [
        _host(WINDOW_SPAN, 0, 1000),
        _host(CALL_SPAN, 0, 500),
        _host("rwt.e2e", 10, 480),
        _host("rwt.driver.relax", 20, 180),
        _host("rwt.tail", 200, 280),
        _host(CALL_SPAN, 500, 500),
        _host("rwt.api.transform_to_list", 510, 480),
        _host("rwt.api.device_curves", 520, 180),
        _host("rwt.driver.relax", 530, 120),
        _host("rwt.api.curve_tail", 700, 3),
        _host("rwt.api.curve_tail", 710, 7),
        _host("rwt.api.curve_tail", 720, 4),
        _ev("rwt.driver.relax", "gpu_user_annotation", 530, 120, tid=7),  # the range's device copy: not busy
        _ev("rwt.driver.relax", "user_annotation", 0, 1000, tid=2),  # another thread: not the window's
        _kernel(25, 75), _kernel(120, 30), _kernel(210, 190), _kernel(540, 100),
    ]


def _ctx(tr, counters=None, calls=2):
    return SimpleNamespace(calls=calls, counters=counters or {}, trace=tr, shape=(64, 64), spans={})


def _readers():
    r = {**spec.resolve("tile4096.merge_nan10").readers, **spec.resolve("cutout1024.to_list").readers}
    assert set(NEW) <= set(r)
    return r


def test_overlap_of_sorted_intervals():
    assert overlap_us([], [(0, 5)]) == 0
    assert overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert overlap_us([(0, 2), (3, 4)], [(0, 100)]) == 3
    assert overlap_us([(0, 10)], [(10, 20)]) == 0


def test_idle_under_spans_at_any_depth_and_across_an_edge():
    tr = _window()
    assert tr.busy_us == 75 + 30 + 190 + 100  # the annotation's device copy adds nothing
    # relax spans 20-200 and 530-650: 5 + 20 + 50 (150-200 of the gap 150-210) + 10 + 10
    assert idle_ms_per_call(_ctx(tr), "rwt.driver.relax") == pytest.approx(95 / 2 / 1e3)
    # tail span 200-480: 10 (200-210) + 80 (400-480)
    r = _readers()
    assert r["tail.idle_ms"](_ctx(tr)) == pytest.approx(90 / 2 / 1e3)
    assert r["driver.idle_ms"](_ctx(tr)) == pytest.approx(95 / 2 / 1e3)
    # The idle gaps are put down to the innermost program span at their middle.
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"rwt.e2e": 25e-6, "rwt.driver.relax": 80e-6, "rwt.tail": 140e-6,
                                  "rwt.api.transform_to_list": 360e-6})


def test_span_medians_and_counters():
    r = _readers()
    ctx = _ctx(_window(), {"host_reads": 94, "relax_tiles": 1000, "relax_tiles_skipped": 250, "relax": 9})
    assert r["api.curve_tail_ms"](ctx) == pytest.approx(4e-3)
    assert r["api.device_curves_ms"](ctx) == pytest.approx(0.18)
    assert median_ms(ctx.trace, "rwt.e2e") == pytest.approx(0.48)
    assert r["driver.host_reads"](ctx) == 47
    assert r["relax.tiles_run_pct"](ctx) == pytest.approx(75.0)
    ctx.counters = {"relax_tiles": 40}
    assert r["relax.tiles_run_pct"](ctx) == 100.0  # no skip counted: every tile ran


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_or_counters_reads_none(name):
    """The parent program opens no ``rwt.*`` span and has no such counter:
    each reader finds nothing and returns None, and so with no call."""
    r = _readers()
    bare = Trace([_host(WINDOW_SPAN, 0, 100), _host(CALL_SPAN, 0, 100), _kernel(10, 20),
                  _ev("rwt.driver.relax", "gpu_user_annotation", 0, 100, tid=7)])
    assert r[name](_ctx(bare, {"relax": 4, "coarse_round": 43})) is None
    if name.startswith(("driver.idle", "tail.idle")):
        assert r[name](_ctx(_window(), calls=0)) is None
        no_device = Trace([e for e in _window_events() if e["cat"] != "kernel"])
        assert r[name](_ctx(no_device)) is None
