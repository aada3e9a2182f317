"""The port's layer spans (``utils.tracing.span``) and host-read counters:
under ``trace()`` the public calls and the merging driver leave their
``rwt.*`` ranges in the Chrome trace, nested by layer; with no profiler a
span is one shared no-op that never builds a ``record_function``; and
``_ext.launches["host_reads"]`` counts each flag read of the merging path
(one a block of relax calls, one a block of coarse rounds, one a fine
round)."""

import json

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.ops.pipeline import max_seed_count, watershed_e2e
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
from rustronomy_watershed_tpu_torch.utils import tracing
from rustronomy_watershed_tpu_torch.utils.tracing import trace, trace_artifacts


def _nan_dots(shape=(48, 56)):
    """Uniform levels with 10% NEVER_FILL dots: the merging shortcut does
    not fire, so the component-min tail runs."""
    rng = np.random.default_rng(42)
    img = rng.integers(0, 60, size=shape).astype(np.uint8)
    img[rng.random(shape) < 0.1] = 255
    return img


def _ws():
    return TransformBuilder.default().set_device("cpu").build_merging()


def _spans(log_dir) -> list:
    """``(name, start, end, thread)`` of the ``rwt.*`` ranges in the one
    trace file under ``log_dir``."""
    (art,) = trace_artifacts(log_dir)
    events = json.loads(art.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name", "").startswith("rwt.")]


def _parent(spans, child):
    """The innermost span that encloses ``child`` on its thread (None at the
    top)."""
    name, s, e, tid = child
    outer = [x for x in spans if x is not child and x[3] == tid and x[1] <= s and e <= x[2]]
    return min(outer, key=lambda x: x[2] - x[1])[0] if outer else None


def _tree(spans) -> dict:
    return {x[0]: _parent(spans, x) for x in spans}


def test_api_spans_nest_by_layer(tmp_path):
    img = _nan_dots()
    ws = _ws()
    with trace(tmp_path):
        seeds = ws.find_local_minima(img)
        rows = ws.transform_to_list(img, seeds)
    assert len(rows) == 255 and rows[-1][1].shape == (img.size + 1,)
    spans = _spans(tmp_path)
    assert sorted(x[0] for x in spans) == sorted([
        "rwt.api.find_local_minima", "rwt.api.seed_list", "rwt.api.transform_to_list", "rwt.api.prepare",
        "rwt.api.device_curves", "rwt.pack", "rwt.driver.relax", "rwt.api.fetch_planes", "rwt.api.curve_tail",
        "rwt.api.expand_rows",
    ])
    assert _tree(spans) == {
        "rwt.api.find_local_minima": None,
        "rwt.api.seed_list": "rwt.api.find_local_minima",
        "rwt.api.transform_to_list": None,
        "rwt.api.prepare": "rwt.api.transform_to_list",
        "rwt.api.device_curves": "rwt.api.transform_to_list",
        "rwt.pack": "rwt.api.device_curves",
        "rwt.driver.relax": "rwt.api.device_curves",
        "rwt.api.fetch_planes": "rwt.api.transform_to_list",
        "rwt.api.curve_tail": "rwt.api.transform_to_list",
        "rwt.api.expand_rows": "rwt.api.transform_to_list",
    }


def test_merging_e2e_spans(tmp_path):
    _ext.reset_launches()
    with trace(tmp_path):
        watershed_e2e(_nan_dots(), merging=True, device="cpu")
    assert _ext.launches["merge_tail"] == 1
    spans = _spans(tmp_path)
    assert sorted(x[0] for x in spans) == ["rwt.driver.relax", "rwt.e2e", "rwt.pack", "rwt.tail"]
    assert _tree(spans) == {"rwt.e2e": None, "rwt.pack": "rwt.e2e", "rwt.driver.relax": "rwt.e2e",
                            "rwt.tail": "rwt.e2e"}


def _merge(img, n_labels):
    """Merging with labels bounded by ``n_labels``: 2**24 or more fails the
    coarse gate, so the fine scan tail runs."""
    return run_levels_impl(img, None, max_water_level=254, merging=True, n_labels=n_labels, backend="packed",
                           device="cpu")


@pytest.mark.parametrize("route", ["fine", "coarse"])
def test_the_fine_tail_span_nests_in_the_tail(tmp_path, route):
    img = _nan_dots()
    with trace(tmp_path):
        _merge(img, 1 << 24 if route == "fine" else max_seed_count(img.shape))
    spans = _spans(tmp_path)
    tail = ["rwt.tail", "rwt.tail.fine"] if route == "fine" else ["rwt.tail"]
    assert sorted(x[0] for x in spans) == ["rwt.driver.relax", "rwt.pack"] + tail
    assert _tree(spans) == {"rwt.pack": None, "rwt.driver.relax": None, "rwt.tail": None,
                            **({"rwt.tail.fine": "rwt.tail"} if route == "fine" else {})}


def test_span_is_the_shared_no_op_without_a_profiler(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("rwt.e2e") is tracing._NO_SPAN
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(tracing.span("rwt.e2e"), torch.profiler.record_function)
    img = _nan_dots()
    want = watershed_e2e(img, merging=True, device="cpu")
    ws = _ws()
    want_rows = ws.transform_to_list(img, ws.find_local_minima(img))

    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) built with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert torch.equal(watershed_e2e(img, merging=True, device="cpu"), want)
    rows = ws.transform_to_list(img, ws.find_local_minima(img))
    assert all(a == c and np.array_equal(b, d) for (a, b), (c, d) in zip(rows, want_rows))


def _tail_reads(n) -> int:
    """The coarse tail's reads: one a block of ``_TAIL_BLOCK`` rounds, up to
    the block that holds the quiet round."""
    from rustronomy_watershed_tpu_torch.ops import scan_merge

    return -(-n["coarse_round_plain"] // scan_merge._TAIL_BLOCK)


def _relax_reads(n) -> int:
    """The relax fixed point's reads: one a block of ``_RELAX_BLOCK`` calls,
    up to the block that holds the certifying call (``relax_reads``)."""
    from rustronomy_watershed_tpu_torch.ops import relax

    reads = -(-n["relax_plain"] // relax._RELAX_BLOCK)
    assert n["relax_reads"] == reads
    return reads


@pytest.mark.parametrize("tail_legacy", [False, True])
def test_host_reads_count_the_merging_flag_reads(monkeypatch, tail_legacy):
    """One read a block of relax calls and, on the tail, one a block of
    coarse rounds, or one a legacy pass 2 with ``RWT_COARSE_MULTI=0``, and
    nothing else."""
    from rustronomy_watershed_tpu_torch.ops import scan_merge

    monkeypatch.setattr(scan_merge, "_COARSE_MULTI", not tail_legacy)
    _ext.reset_launches()
    watershed_e2e(_nan_dots(), merging=True, device="cpu")
    n = _ext.launches
    rounds = n["cbwd_vh_plain"] if tail_legacy else n["coarse_round_plain"]
    assert n["merge_tail"] == 1 and n["relax_plain"] > 0 and rounds > 0
    assert n["host_reads"] == _relax_reads(n) + (rounds if tail_legacy else _tail_reads(n))
    assert n["relax_tiles"] == n["relax_tiles_skipped"] == 0  # the twin runs no tile


def test_host_reads_of_the_api_calls():
    """``transform_to_list``: the seed list, a read a block of relax calls
    and the compact planes; ``transform``: a read a block of relax calls and
    a block of tail rounds, and the labels."""
    img = _nan_dots()
    ws = _ws()
    _ext.reset_launches()
    seeds = ws.find_local_minima(img)
    ws.transform_to_list(img, seeds)
    assert _ext.launches["host_reads"] == 1 + _relax_reads(_ext.launches) + 1
    _ext.reset_launches()
    ws.transform(img, seeds)
    n = _ext.launches
    assert n["merge_tail"] == 1 and n["host_reads"] == _relax_reads(n) + _tail_reads(n) + 1


def test_host_reads_of_the_fine_tail():
    """The fine route reads once a block of relax calls and once a fine
    round, each round's flag: its counters add no read."""
    _ext.reset_launches()
    _merge(_nan_dots(), 1 << 24)
    n = _ext.launches
    assert n["merge_tail"] == 1 and n["fine_tail"] == 1 and n["fine_round"] == n["bwd_vh_plain"] >= 1
    assert n["host_reads"] == _relax_reads(n) + n["fine_round"]
