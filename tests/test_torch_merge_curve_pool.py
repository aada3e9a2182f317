"""The merged-curve tail's pool of released result blocks
(ops/merge_curve.py ``ResultBlocks``): a pooled block gives the same curve
as a fresh ``np.zeros`` block and the NumPy pair, whatever the last result
or its user left in it; it is never handed out while a view of it lives;
the counters say which blocks were reused.  The pool's threshold is
lowered so that these small fields use it."""

import sys
import threading

import numpy as np
import pytest

from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import merge_curve as mc
from rustronomy_watershed_tpu_torch.parity import native
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

SHAPE = (40, 50)
WIDTH = SHAPE[0] * SHAPE[1] + 1  # the reference's n_pixels + 1: 16 008 B a row, rows off the page grid
MAXLVL = 254


@pytest.fixture
def pool(monkeypatch):
    blocks = mc.ResultBlocks()
    monkeypatch.setattr(mc, "_BLOCKS", blocks)
    monkeypatch.setattr(mc, "POOL_MIN_BYTES", 0)
    yield blocks
    blocks.clear()


def _inputs(seed, k, maxlvl=MAXLVL, n_edges=60):
    rng = np.random.default_rng(seed)
    levels = maxlvl + 1
    labels = rng.integers(0, k + 1, size=SHAPE).astype(np.int32)
    lv8 = rng.integers(0, levels + 1, size=SHAPE).astype(np.uint8)
    lv8[labels == 0] = levels  # never claimed
    lo = rng.integers(1, k, n_edges).astype(np.int32)
    hi = (lo + rng.integers(1, 4, n_edges)).clip(max=k).astype(np.int32)
    act = rng.integers(0, levels, n_edges).astype(np.int32)
    return labels, lv8, k, maxlvl, lo, hi, act


def _counts():
    return _ext.launches["curve_block_reused"], _ext.launches["curve_block_new"]


def _delta(before):
    now = _counts()
    return now[0] - before[0], now[1] - before[1]


def _check(got, args, width=WIDTH):
    want = native.native_merged_curve(*args, out_width=width)
    assert want.flags.owndata  # the fresh np.zeros block
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mc.merged_curve_plain(*args, out_width=width))


def test_pooled_results_over_a_chain_of_k(pool):
    # K grows, shrinks, grows again, past the width once (copy_w = width).
    before = _counts()
    for i, k in enumerate([23, 700, 1900, 5, 60, 1200, 2400, 300]):
        args = _inputs(i, k)
        got = mc.merged_curve_host(*args, out_width=WIDTH)
        assert not got.flags.owndata  # a pooled mapping
        _check(got, args)
        del got
    assert _delta(before) == (7, 1)


@pytest.mark.parametrize("where", ["prefix", "past_copy_w", "row_end", "far_pages", "everywhere"])
def test_user_writes_into_a_released_block_leave_no_trace(pool, where):
    args = _inputs(1, 900)
    got = mc.merged_curve_host(*args, out_width=WIDTH)
    rows = list(enumerate(got))
    del got
    copy_w = 40  # the next call's K + 1
    for _, row in rows:
        if where == "prefix":
            row[: copy_w] = -7
        elif where == "past_copy_w":
            row[copy_w : copy_w + 3] = -7  # the same page as the next call's prefix
        elif where == "row_end":
            row[-3:] = -7  # a page shared with the next row's start
        elif where == "far_pages":
            row[copy_w + 900 :: 97] = -7
        else:
            row[:] = -7
    del row, rows
    before = _counts()
    args = _inputs(2, copy_w - 1)
    got = mc.merged_curve_host(*args, out_width=WIDTH)
    assert _delta(before) == (1, 0)
    _check(got, args)


@pytest.mark.parametrize("hold", ["rows", "one_row"])
def test_a_live_view_keeps_its_block_out_of_the_pool(pool, hold):
    args = _inputs(3, 800)
    got = mc.merged_curve_host(*args, out_width=WIDTH)
    kept = list(enumerate(got)) if hold == "rows" else got[100]
    want = np.array([r for _, r in kept]) if hold == "rows" else kept.copy()
    del got
    before = _counts()
    nxt_args = _inputs(4, 1500)
    nxt = mc.merged_curve_host(*nxt_args, out_width=WIDTH)
    assert _delta(before) == (0, 1)
    views = [r for _, r in kept] if hold == "rows" else [kept]
    assert not any(np.shares_memory(nxt, v) for v in views)
    _check(nxt, nxt_args)
    np.testing.assert_array_equal(np.array([r for _, r in kept]) if hold == "rows" else kept, want)
    del nxt  # released into the empty slot; the held block cannot be taken
    before = _counts()
    third = mc.merged_curve_host(*args, out_width=WIDTH)
    assert _delta(before) == (1, 0)
    assert not any(np.shares_memory(third, v) for v in views)
    _check(third, args)
    del views, third
    del kept  # now the held block dies; the slot is full, so it is unmapped
    before = _counts()
    got = mc.merged_curve_host(*args, out_width=WIDTH)
    assert _delta(before) == (1, 0)
    _check(got, args)


def test_the_counters_and_the_one_slot(pool):
    args = _inputs(5, 300)
    before = _counts()
    a = mc.merged_curve_host(*args, out_width=WIDTH)
    b = mc.merged_curve_host(*args, out_width=WIDTH)
    assert _delta(before) == (0, 2)
    del a, b  # one kept, one unmapped
    c = mc.merged_curve_host(*args, out_width=WIDTH)
    d = mc.merged_curve_host(*args, out_width=WIDTH)
    assert _delta(before) == (1, 3)
    _check(c, args)
    _check(d, args)
    del c
    pool.clear()
    e = mc.merged_curve_host(*args, out_width=WIDTH)
    assert _delta(before) == (1, 4)
    _check(e, args)


@pytest.mark.parametrize("other", ["width", "levels"])
def test_a_block_of_another_shape_is_not_reused(pool, other):
    args = _inputs(6, 400)
    got = mc.merged_curve_host(*args, out_width=WIDTH)
    got[:] = -3
    del got
    before = _counts()
    if other == "width":
        width, nxt_args = WIDTH + 513, _inputs(7, 400)
    else:
        width, nxt_args = WIDTH, _inputs(7, 400, maxlvl=200)
    nxt = mc.merged_curve_host(*nxt_args, out_width=width)
    assert _delta(before) == (0, 1)
    _check(nxt, nxt_args, width)


def test_compact_rows_and_small_blocks_take_np_zeros(monkeypatch):
    blocks = mc.ResultBlocks()
    monkeypatch.setattr(mc, "_BLOCKS", blocks)
    before = _counts()
    args = _inputs(8, 300)
    for width in (WIDTH, None, 7):  # under the default threshold: every CPU test field
        got = mc.merged_curve_host(*args, out_width=width)
        assert got.flags.owndata
        _check(got, args, width)
    monkeypatch.setattr(mc, "POOL_MIN_BYTES", 0)
    for width in (None, 301):  # compact rows (K + 1), above the lowered threshold
        got = mc.merged_curve_host(*args, out_width=width)
        assert got.flags.owndata
        _check(got, args, width)
    assert _delta(before) == (0, 0)


def test_native_curve_refuses_a_wrong_out_block():
    args = _inputs(9, 50)
    levels = MAXLVL + 1
    for bad in (
        np.zeros((levels, WIDTH - 1), np.int64),
        np.zeros((levels, WIDTH), np.int32),
        np.zeros((levels, 2 * WIDTH), np.int64)[:, ::2],
    ):
        with pytest.raises(ValueError, match="out must be"):
            native.native_merged_curve(*args, out_width=WIDTH, out=bad)
    ro = np.zeros((levels, WIDTH), np.int64)
    ro.flags.writeable = False
    with pytest.raises(ValueError, match="out must be"):
        native.native_merged_curve(*args, out_width=WIDTH, out=ro)
    out = np.zeros((levels, WIDTH), np.int64)
    assert native.native_merged_curve(*args, out_width=WIDTH, out=out) is out
    _check(out, args)


def test_transform_to_list_rows_from_the_pool(pool, monkeypatch):
    """The public API at the reference's row width: held rows keep their
    values while later calls run, and every call's rows equal those of a
    fresh block."""
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 254, size=(24, 28)).astype(np.uint8) for _ in range(3)]
    ws = TransformBuilder.default().set_device("cpu").build_merging()
    monkeypatch.setattr(mc, "POOL_MIN_BYTES", 64 * 1024 * 1024)
    plain = [np.array([r for _, r in ws.transform_to_list(img, ws.find_local_minima(img))]) for img in imgs]
    monkeypatch.setattr(mc, "POOL_MIN_BYTES", 0)
    before = _counts()
    held = ws.transform_to_list(imgs[0], ws.find_local_minima(imgs[0]))
    for i in (1, 2, 1, 0):
        rows = ws.transform_to_list(imgs[i], ws.find_local_minima(imgs[i]))
        np.testing.assert_array_equal(np.array([r for _, r in rows]), plain[i])
        assert not any(np.shares_memory(r, h) for _, r in rows[:: len(rows) - 1] for _, h in held)
        del rows
    np.testing.assert_array_equal(np.array([r for _, r in held]), plain[0])
    assert _delta(before) == (3, 2)  # new: the held block and the loop's first


def test_threads_never_share_a_live_block(pool):
    """More threads than cores, a short switch interval: no result is
    handed a block that another live result sees, and every curve is
    right."""
    inputs = [_inputs(20 + i, 40 + 97 * i) for i in range(4)]
    wants = [native.native_merged_curve(*a, out_width=WIDTH) for a in inputs]
    errors, live, lock = [], [], threading.Lock()

    def work(t):
        try:
            for j in range(12):
                i = (t + j) % len(inputs)
                got = mc.merged_curve_host(*inputs[i], out_width=WIDTH)
                with lock:
                    if any(np.shares_memory(got, other) for other in live):
                        errors.append("shared")
                    live.append(got)
                if not np.array_equal(got, wants[i]):
                    errors.append(f"curve {i}")
                with lock:
                    live[:] = [o for o in live if o is not got]
                del got
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    reused, new = _counts()
    assert reused > 0 and new > 0
