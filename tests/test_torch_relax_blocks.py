"""The relax fixed point's calls in blocks (``relax.relax_fixed_point``) on
the plain twin: each call after the first stops when the call before it
certified the fixed point (``go``, its LAST flag), the host reads one block
of flags while the next block is queued, and the loop ends at the first
block that holds a quiet call.  Planes, ``starved``, the statistics, ``y0``
and ``y0_valid`` must equal those of the loop that reads every call's
flags; ``relax_plain`` counts the calls that ran, ``relax_stopped`` those
that stopped, ``relax_reads`` the blocks read."""

import math

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import relax
from rustronomy_watershed_tpu_torch.ops.pack import pack_domain, pack_plain
from torch_fields import plateau

K = relax._RELAX_BLOCK
STEPS = 2


def _line(length: int):
    """Packed planes of a one-row corridor of ``length`` pixels at level 5
    in NEVER_FILL, seeded at its left end: at 2 sweeps a call its fixed
    point takes ``ceil(length / 2)`` calls, the quiet one included."""
    img = np.full((3, length + 2), 255, np.uint8)
    img[1, 1 : length + 1] = 5
    lab0 = torch.zeros(img.shape, dtype=torch.int32)
    lab0[1, 1] = 1
    return pack_domain(torch.from_numpy(img), lab0)


def _plateau(shape=(64, 64)):
    """Wide plateaus of levels 0..3 with seeds from the image: 15 calls of
    2 sweeps at 64 x 64."""
    v, key, lab, _ = pack_plain(torch.from_numpy(plateau(shape, 3)))
    return v, key, lab


def _call_by_call(v, key, lab, steps=STEPS, stats=False, fwd_scan=False):
    """The loop that reads every call's flags: ``(key, lab, flags, calls,
    y0)``, the flags the certifying call's; ``fwd_scan`` implies the
    statistics."""
    src, calls, y0, stats = (key.clone(), lab.clone()), 0, None, stats or fwd_scan
    while True:
        k2, l2, flags, *y = relax.relax_block_plain(v, *src, steps, stats=stats, fwd_scan=fwd_scan and calls == 0)
        y0 = y[0] if y else y0
        calls += 1
        src = (k2, l2)
        f = flags.tolist()
        if not f[relax.LAST]:
            return k2, l2, f, calls, y0


def _check_blocked(v, key, lab, k, *, stats=False, fwd_scan=False):
    """The blocked fixed point against the call-by-call loop; returns the
    number of calls."""
    want_k, want_l, f, need, want_y0 = _call_by_call(v, key, lab, stats=stats, fwd_scan=fwd_scan)
    _ext.reset_launches()
    got = relax.relax_fixed_point(v, key.clone(), lab.clone(), steps=STEPS, stats=stats, fwd_scan=fwd_scan)
    n = _ext.launches
    assert torch.equal(got[0], want_k) and torch.equal(got[1], want_l)
    assert got[2] == bool(f[relax.SAT])
    if stats or fwd_scan:
        assert got[3] == (f[relax.N_UNCL], bool(f[relax.ANY_BORDER]), f[relax.GMIN])
    if fwd_scan:
        assert torch.equal(got[4], want_y0) and got[5] == (need == 1)
    blocks = math.ceil(need / k)  # the blocks read: the last holds the certifying call
    assert n["relax_plain"] == need and n["relax_reads"] == n["host_reads"] == blocks
    assert n["relax_stopped"] == (blocks + 1) * k - need  # the rest of the last block and the next
    assert k <= n["relax_stopped"] <= 2 * k - 1
    assert n["relax"] == n["relax_launched"] == 0  # the kernel's counters: no kernel ran
    return need


CASES = [(k, need) for k in (K, 3) for need in range(1, 2 * k + 2)]


@pytest.mark.parametrize("k,need", CASES, ids=[f"k{k}-calls{c}" for k, c in CASES])
def test_blocked_fixed_point_matches_the_call_by_call_loop(monkeypatch, k, need):
    """Fixed points that certify at every position of a block and across a
    block boundary, from one call to ``2k + 1``."""
    monkeypatch.setattr(relax, "_RELAX_BLOCK", k)
    assert _check_blocked(*_line(2 * need - 1), k) == need


@pytest.mark.parametrize("fwd_scan", [False, True])
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("need", [1, K, K + 1, 2 * K + 1])
def test_blocked_statistics_and_y0(need, stats, fwd_scan):
    """The certifying call's statistics, and ``y0`` of the first call with
    ``y0_valid`` only where that call certified."""
    assert _check_blocked(*_line(2 * need - 1), K, stats=stats, fwd_scan=fwd_scan) == need


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("k", [K, 3, 8])
def test_blocked_plateau_field(monkeypatch, k, stats):
    """A plateau field's long fixed point (15 calls) with seeds from the
    image."""
    monkeypatch.setattr(relax, "_RELAX_BLOCK", k)
    assert _check_blocked(*_plateau(), k, stats=stats) == 15


@pytest.mark.parametrize("fwd_scan", [False, True])
def test_on_call_reads_each_call(fwd_scan):
    """With ``on_call`` the fixed point reads each call before it queues the
    next: the hook sees every call's input and output planes and its flags
    as the twin gives them, nothing stops, and there is a read a call."""
    v, key, lab = _plateau((48, 64))
    seen = []

    def on_call(src, dst, flags, skipped):
        want = relax.relax_block_plain(v, *src, STEPS, stats=fwd_scan)
        assert torch.equal(dst[0], want[0]) and torch.equal(dst[1], want[1])
        assert flags.tolist() == want[2].tolist() and skipped == 0
        seen.append(flags.tolist())

    _ext.reset_launches()
    got = relax.relax_fixed_point(v, key.clone(), lab.clone(), steps=STEPS, on_call=on_call, fwd_scan=fwd_scan)
    n = dict(_ext.launches)
    want = relax.relax_fixed_point(v, key.clone(), lab.clone(), steps=STEPS, fwd_scan=fwd_scan)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2])) and got[2:4] == want[2:4]
    assert len(seen) == 13 and not seen[-1][relax.LAST] and all(f[relax.LAST] for f in seen[:-1])
    assert n["relax_plain"] == 2 * len(seen)  # the fixed point's calls and the hook's
    assert n["relax_stopped"] == 0 and n["relax_reads"] == n["host_reads"] == len(seen)


def test_a_call_whose_go_is_zero_stops():
    """``go`` 0: ``out`` stays, the flags read 0 and the call counts as
    stopped; ``go`` nonzero: the call that ``go=None`` runs."""
    v, key, lab = _plateau((48, 64))
    out = (torch.full_like(key, -7), torch.full_like(lab, -7))
    _ext.reset_launches()
    for stats in (False, True):
        k2, l2, flags = relax.relax_block_plain(v, key, lab, STEPS, out=out, stats=stats,
                                                go=torch.zeros((1,), dtype=torch.int32))
        assert k2 is out[0] and l2 is out[1] and (k2 == -7).all() and (l2 == -7).all()
        assert flags.tolist() == [0] * (6 if stats else 3)
    assert _ext.launches["relax_stopped"] == 2 and _ext.launches["relax_plain"] == 0
    want = relax.relax_block_plain(v, key, lab, STEPS, stats=True)
    got = relax.relax_block_plain(v, key, lab, STEPS, out=out, stats=True, go=torch.ones((1,), dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and got[0] is out[0]
    assert _ext.launches["relax_stopped"] == 2 and _ext.launches["relax_plain"] == 2


def test_go_refusals():
    v, key, lab = _plateau((16, 16))
    out = (torch.empty_like(key), torch.empty_like(lab))
    one = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="one-element int32"):
        relax.relax_block_plain(v, key, lab, STEPS, out=out, go=torch.ones((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match="one-element int32"):
        relax.relax_block_plain(v, key, lab, STEPS, out=out, go=torch.ones((1,), dtype=torch.int64))
    with pytest.raises(ValueError, match="writes into out"):
        relax.relax_block_plain(v, key, lab, STEPS, go=one)
    with pytest.raises(ValueError, match="not the y0 call"):
        relax.relax_block_plain(v, key, lab, STEPS, out=out, fwd_scan=True, go=one)
