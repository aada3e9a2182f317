"""The legacy coarse pass 2's row kernel (``hwin_ring`` in
csrc/scan_round.cu, the ring route of ``cbwd_vh``) as a NumPy model, on the
CPU.

The model walks a plane as the kernel does: bands of rows, each from the
row above it (the shadow row, computed for the stencil and not stored), in
ring steps of ``rows_per_step`` whole rows laid out at the byte phase of the
step's first row, 20 cells a thread.  Inside a thread it runs the kernel's
segmented scans; an exclusive scan over the threads' aggregates gives the
carries.  The window is exact by van Herk / Gil-Werman blocks of ``reach +
1`` columns from each row's column 0 and scans of the reset positions; the
violation stencil checks both halves on the step's output, the row above a
step's first row taken from the previous step's buffer.

It is held against ``cbwd_vh_plain``'s row half (the input's bit 25 set
everywhere makes the column scan the identity) and ``_coarse_violations``,
and the twin against a brute-force window min, over widths, reaches,
phases, plans with many band and step boundaries, and many seeds for the
flag.  The plan test holds ``legacy_row_plan``: the plane covered, the
shared memory in bounds, the ring route up to ``_ROW_CAP``.  Integer
outputs, tolerance 0.
"""

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu_torch.ops import scan_merge as sm

torch.set_num_threads(1)
INF = 1 << 29  # kInf
KR = 1 << 30  # kR: "a segment starts here" in a scan element
KVM = KR - 1
CELLS = 20  # kCells
VAL = sm._CVAL
SMEM_LIMIT = 232448 - 1024  # a block's shared memory on Hopper, less the kernel's static arrays


def _comb(a: int, b: int) -> int:
    """The segmented-min operator of the kernel's scans, a then b."""
    return b if b & KR else min(a & KVM, b) | (a & KR)


def _exclusive(xs, reverse=False):
    """Exclusive scan of the threads' aggregates under ``_comb`` (threads in
    order, or in reverse): what ``block_scans`` gives each thread."""
    out, acc = np.empty(len(xs), np.int64), INF
    for t in (range(len(xs) - 1, -1, -1) if reverse else range(len(xs))):
        out[t] = acc
        acc = _comb(acc, int(xs[t]))
    return out


def _scan(v, restart, init, reverse=False):
    """Each thread's segmented min scan over its 20 cells from ``init``."""
    out, acc = np.empty_like(v), init.copy()
    for k in range(CELLS - 1, -1, -1) if reverse else range(CELLS):
        acc = np.where(restart[:, k], v[:, k], np.minimum(acc, v[:, k]))
        out[:, k] = acc
    return out


def _aggregate(local, restart, reverse=False):
    return local[:, 0 if reverse else -1] | np.where(restart.any(1), KR, 0)


def _step(buf, ph, S, w, reach, threads):
    """One ring step: the buffer's cells -> (output cells, values), as hwin_ring."""
    pos = np.arange(threads * CELLS).reshape(threads, CELLS)
    i = pos - ph
    m_in = (i >= 0) & (i < S)
    col = np.where(m_in, i % w, -1)
    first, last = m_in & (col == 0), m_in & (col == w - 1)
    c = buf.reshape(threads, CELLS)
    lab = c & VAL
    v = np.where(m_in & (lab != 0), lab, INF)
    bit = lambda b: ((c >> b) & 1).astype(bool)  # noqa: E731
    rf, rb = bit(26) | ~m_in | first, bit(27) | ~m_in | last
    none = np.full(threads, INF, np.int64)
    if not 0 <= reach < w - 1:
        f, b = _scan(v, rf, none), _scan(v, rb, none, reverse=True)
        cf = _exclusive(_aggregate(f, rf)) & KVM
        cb = _exclusive(_aggregate(b, rb, reverse=True), reverse=True) & KVM
        lead = np.cumsum(rf, 1) == 0
        trail = np.cumsum(rb[:, ::-1], 1)[:, ::-1] == 0
        o = np.minimum(np.minimum(f, b), np.minimum(np.where(lead, cf[:, None], INF), np.where(trail, cb[:, None], INF)))
    else:
        B = reach + 1
        rg = (m_in & ((col & reach) == 0)) | ~m_in | first
        rh = (m_in & ((col & reach) == reach)) | ~m_in | last
        last_f = np.where(rf.any(1), pos[:, 0] + CELLS - 1 - np.argmax(rf[:, ::-1], 1), -1)
        first_b = np.where(rb.any(1), pos[:, 0] + np.argmax(rb, 1), -1)
        cf = _exclusive(_aggregate(_scan(v, rf, none), rf)) & KVM
        cg = _exclusive(_aggregate(_scan(v, rg, none), rg)) & KVM
        cpf = _exclusive(np.where(last_f >= 0, last_f | KR, INF)) & KVM
        cb = _exclusive(_aggregate(_scan(v, rb, none, True), rb, True), True) & KVM
        ch = _exclusive(_aggregate(_scan(v, rh, none, True), rh, True), True) & KVM
        cpb = _exclusive(np.where(first_b >= 0, first_b | KR, INF), True) & KVM
        g, h = _scan(v, rg, cg), _scan(v, rh, ch, reverse=True)
        gs, hs = g.reshape(-1), h.reshape(-1)
        pf, pb = _scan(v, rf, cf), _scan(v, rb, cb, reverse=True)
        lf, lb = np.empty_like(pos), np.empty_like(pos)
        acc = cpf.copy()
        for k in range(CELLS):
            acc = np.where(rf[:, k], pos[:, k], acc)
            lf[:, k] = acc
        acc = cpb.copy()
        for k in range(CELLS - 1, -1, -1):
            acc = np.where(rb[:, k], pos[:, k], acc)
            lb[:, k] = acc
        in_f, in_b = lf > pos - B, lb < pos + B  # a reset inside the window
        # Where the window crosses a block edge it lies in the span.
        assert (pos - B + 1)[~in_f].min(initial=0) >= 0 and (pos + B - 1)[~in_b].max(initial=0) < len(gs)
        hf = np.where(in_f, pf, np.minimum(hs[np.clip(pos - B + 1, 0, None)], g))
        hb = np.where(in_b, pb, np.minimum(h, gs[np.clip(pos + B - 1, None, len(gs) - 1)]))
        o = np.minimum(hf, hb)
    live = m_in & (lab != 0)
    o = np.where(live, o, 0)
    cells = np.where(live, (c & ~VAL) | o, c)
    edges_v, edges_h = ~bit(24) & m_in, ~bit(26) & m_in & ~first
    return cells.reshape(-1), o, i, edges_v, edges_h


def model_row_pass(x, reach, plan, phase0=0, seed=0):
    """The ring route of cbwd_vh's row half on the scratch plane ``x`` (cells
    with the column scan's values and the input's bits): ``(out, flag)``.
    ``phase0`` is the plane's first cell's phase in its 16-byte line; cells
    of a buffer outside the step's span hold junk."""
    h, w = x.shape
    flat = x.reshape(-1).astype(np.int64)
    out = np.zeros_like(flat)
    junk = np.random.default_rng(seed)
    g, band, threads = plan["rows_per_step"], plan["band_rows"], plan["threads"]
    bad = False
    for r0 in range(0, h, band):
        r_end = min(h, r0 + band)
        rs = r0 - 1 if r0 > 0 else 0
        prev = None
        for s in range(-(-(r_end - rs) // g)):
            a = rs + s * g
            S = min(g, r_end - a) * w
            ph = (phase0 + a * w) & 3
            assert S + ph <= threads * CELLS
            buf = junk.integers(0, 1 << 31, threads * CELLS)
            buf[ph : ph + S] = flat[a * w : a * w + S]
            cells, o, i, ev, eh = _step(buf, ph, S, w, reach, threads)
            if s == 0:  # row 0 has no row above; the shadow row's pairs are the band above's
                ev &= i >= w
                if r0 > 0:
                    eh &= i >= w
            labs = cells & VAL
            up = labs[np.clip(ph + i - w, 0, None)]
            if prev is not None:  # the row above a step's first row ends the previous buffer
                up = np.where(i < w, prev[np.clip(prev_base + i - w, 0, len(prev) - 1)], up)
            left = labs[np.clip(ph + i - 1, 0, None)]
            bad |= bool((ev & (up != o)).any() | (eh & (left != o)).any())
            lo = w if (s == 0 and r0 > 0) else 0
            out[a * w + lo : a * w + S] = cells[ph + lo : ph + S]
            prev, prev_base = labs, ph + g * w
    return out.reshape(h, w).astype(np.int32), int(bad)


def _plane(shape, seed, p_reset=0.15, n_vals=1 << 20, p_empty=0.1):
    """A random packed plane: values, empties (every reset bit set, as
    coarsen writes them), random reset bits 24, 26, 27; bit 25 set
    everywhere, so that the pass's column scan is the identity."""
    gen = np.random.default_rng(seed)
    val = gen.integers(1, n_vals + 1, shape)
    bits = sum((gen.random(shape) < p_reset).astype(np.int64) << b for b in (24, 26, 27)) | (1 << 25)
    empty = gen.random(shape) < p_empty
    return np.where(empty, 0xF << 24, val | bits).astype(np.int32)


def _twin(c, h_window):
    out, flag = sm.cbwd_vh_plain(torch.from_numpy(c), h_window)
    return out.numpy(), int(flag.item())


def _brute(c, reach):
    """The windowed run-min by definition: each cell the min over at most
    ``reach`` cells back (forward scan, stopping at and taking the last bit-26
    reset) and ahead (bit 27), empty cells kInf and kept."""
    h, w = c.shape
    r = w if reach < 0 else reach
    lab = c & VAL
    v = np.where(lab == 0, INF, lab)
    out = c.copy()
    for y in range(h):
        for x in range(w):
            if lab[y, x] == 0:
                continue
            m = INF
            for j in range(x, max(0, x - r) - 1, -1):
                m = min(m, v[y, j])
                if (c[y, j] >> 26) & 1:
                    break
            for j in range(x, min(w - 1, x + r) + 1):
                m = min(m, v[y, j])
                if (c[y, j] >> 27) & 1:
                    break
            out[y, x] = (c[y, x] & ~VAL) | m
    return out


def _plan(h, w, g, band):
    """A ring plan with ``g`` rows a step and bands of ``band`` rows."""
    g = min(g, h)
    owners = -(-(g * w + 3) // CELLS)
    threads = 32 * -(-owners // 32)
    return {"rows_per_step": g, "band_rows": band, "threads": threads}


WINDOWS = [2, 4, 256, 512, None]  # reach 1, 3, 255, 511 where they bind, else the whole row
WIDTHS = [3, 5, 97, 256, 257, 700, 4096]


@pytest.mark.parametrize("h_window", WINDOWS, ids=[f"win{x}" for x in WINDOWS])
@pytest.mark.parametrize("w", WIDTHS)
def test_model_matches_twin(w, h_window):
    """The model on the real plan and on plans with short steps and bands,
    at each byte phase, equals the twin (plane and flag); the twin equals the
    brute-force window min."""
    h = 5 if w == 4096 else 9
    reach = sm._reach(w, h_window)
    c = _plane((h, w), seed=w + (h_window or 0))
    want, want_flag = _twin(c, h_window)
    if w <= 700:
        np.testing.assert_array_equal(want, _brute(c, reach))
    plans = [sm.legacy_row_plan(h, w, 132, reach), _plan(h, w, 1, 2), _plan(h, w, 2, 3), _plan(h, w, 3, 4)]
    for k, plan in enumerate(plans):
        for phase in range(4):
            if w == 4096 and (k + phase) % 2:
                continue  # half of the wide cases keep the file fast
            got, flag = model_row_pass(c, reach, plan, phase, seed=phase)
            np.testing.assert_array_equal(got, want, err_msg=f"plan {plan} phase {phase}")
            assert flag == want_flag, (plan, phase)


@pytest.mark.parametrize("seed", range(16))
@pytest.mark.parametrize("shape", [(7, 7), (10, 33), (6, 97)], ids=["7x7", "10x33", "6x97"])
def test_model_flag_many_seeds(shape, seed):
    """The flag on planes of few values and sparse resets (runs that a
    window leaves unequal, violations that hinge on one pair), with steps
    and bands of 1-3 rows, so that pairs cross every kind of boundary."""
    h, w = shape
    c = _plane(shape, seed=100 + seed, p_reset=0.05 + 0.05 * (seed % 4), n_vals=3, p_empty=0.05 * (seed % 3))
    for h_window in (2, 4, None):
        reach = sm._reach(w, h_window)
        want, want_flag = _twin(c, h_window)
        for g, band in ((1, 1), (1, 2), (2, 3), (3, 3)):
            got, flag = model_row_pass(c, reach, _plan(h, w, g, band), phase0=seed % 4, seed=seed)
            np.testing.assert_array_equal(got, want)
            assert flag == want_flag, (h_window, g, band)


@pytest.mark.parametrize("w", [5, 97, 700])
def test_model_flag_at_band_and_step_starts(w):
    """A plane whose only violated pair straddles a band start (a vertical
    pair, checked through the shadow row), a step start inside a band (a
    vertical pair, against the previous buffer), or lies in a band's first
    row or in the row above a band (horizontal pairs, left unequal by a
    window of 2): flag 1, as the twin; joined (both values equal, or the
    window off), flag 0."""
    h = 12
    plan = _plan(h, w, 2, 5)  # bands at rows 0, 5, 10; steps from rows 4 and 9 of two rows
    every = 0xF << 24  # every reset bit: no edge
    for kind, r in (("v", 5), ("v", 8), ("v", 10), ("h", 10), ("h", 4), ("h", 0)):
        c = np.full((h, w), every, np.int32)  # every cell empty
        if kind == "v":
            c[r - 1, w // 2] = 5 | every
            c[r, w // 2] = 9 | (every & ~(1 << 24))  # bit 24 clear: an edge to the cell above
            cases = ((c, None, True),)
            d = c.copy()
            d[r, w // 2] = d[r, w // 2] & ~VAL | 5
            cases += ((d, None, False),)
        else:  # 3, 5, 9 joined along the row's last three cells
            c[r, w - 3] = 3 | (every & ~(1 << 27))
            c[r, w - 2] = 5 | (every & ~(1 << 26) & ~(1 << 27))
            c[r, w - 1] = 9 | (every & ~(1 << 26))
            cases = ((c, 2, True), (c, None, False))
        for plane, h_window, violated in cases:
            want, want_flag = _twin(plane, h_window)
            assert want_flag == violated, (kind, r, h_window)
            got, flag = model_row_pass(plane, sm._reach(w, h_window), plan)
            np.testing.assert_array_equal(got, want)
            assert flag == want_flag, (kind, r, h_window)


def _rows_walked(h, plan):
    """(band start, first row, rows, stored) of each step of a ring plan."""
    g, band = plan["rows_per_step"], plan["band_rows"]
    for r0 in range(0, h, band):
        r_end = min(h, r0 + band)
        a = r0 - 1 if r0 > 0 else 0
        while a < r_end:
            n = min(g, r_end - a)
            yield r0, a, n
            a += n


LEGACY_CASES = [
    (2048, 4096, 132), (2048, 4096, 114), (4501, 700, 132), (512, 3, 132), (1, 5, 132), (1, 18432, 132),
    (2, 18433, 132), (150, 18440, 132), (512, 1031, 78), (9, 97, 132), (3, 9597, 132), (3, 9598, 132),
]


@pytest.mark.parametrize("reach", [-1, 1, 255, 511])
@pytest.mark.parametrize("h,w,n_sm", LEGACY_CASES, ids=[f"{h}x{w}@{n}" for h, w, n in LEGACY_CASES])
def test_legacy_row_plan(h, w, n_sm, reach):
    """The ring route up to _ROW_CAP (chunked above), steps of the coarse
    round's size, shared memory for the ring and, windowed, the block mins
    within a block's limit; every row stored once and every vertical pair
    checked once (the band's first through its shadow row)."""
    plan = sm.legacy_row_plan(h, w, n_sm, reach)
    win = 0 <= reach < w - 1
    if w > (9597 if win else sm._ROW_CAP):  # the widest rows of 480 windowed threads' cells
        assert plan["route"] == "chunked" and plan["threads"] == 0
        return
    assert plan["route"] == "ring"
    g, band, threads = plan["rows_per_step"], plan["band_rows"], plan["threads"]
    assert g == sm.row_plan(h, w, n_sm, coarse=True)["rows_per_step"]
    assert g * w + 3 <= threads * CELLS and threads % 32 == 0 and threads <= 1024
    assert plan["smem"] == (6 if win else 3) * threads * CELLS * 4 <= SMEM_LIMIT
    assert band >= min(h, sm._LEGACY_MIN_BAND) and band >= g and plan["n_bands"] == -(-h // band)
    per_sm = min(sm._SM_SMEM // (plan["smem"] + sm._BLOCK_SMEM), sm._SM_THREADS // threads)
    assert per_sm >= 1
    assert plan["n_bands"] <= max(n_sm * per_sm, -(-h // sm._LEGACY_MIN_BAND))
    stored, checked = np.zeros(h, np.int64), np.zeros(h, np.int64)  # checked[r]: the pair (r-1, r)
    for r0, a, n in _rows_walked(h, plan):
        rows = np.arange(a, a + n)
        stored[rows[rows >= r0]] += 1
        checked[rows[1:] if a == max(r0 - 1, 0) else rows] += 1  # not the band's row 0 or shadow row
    assert (stored == 1).all() and checked[0] == 0 and (checked[1:] == 1).all()


def test_legacy_row_plan_at_4096():
    """The main shape: the 4096^2 NaN-dot field's 2048 x 4096 coarse plane,
    one row a step; windowed blocks take six buffers, two to an SM."""
    full, windowed = (sm.legacy_row_plan(2048, 4096, 132, r) for r in (-1, 255))
    assert full["rows_per_step"] == windowed["rows_per_step"] == 1
    assert full["threads"] == windowed["threads"] == 224
    assert windowed["smem"] == 6 * 224 * CELLS * 4 and full["smem"] == 3 * 224 * CELLS * 4
    assert windowed["n_bands"] <= 2 * 132 and full["n_bands"] <= 4 * 132
