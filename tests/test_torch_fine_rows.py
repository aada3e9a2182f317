"""The premise and the launch plans of the fine scan kernels
(csrc/scan_round.cu, ops/scan_merge.py), on the CPU.

* The fused stencil: ``bwd_vh``'s row kernel checks only vertical pairs, so
  on every output of ``bwd_vh_plain`` the full fine witness must equal its
  vertical half (horizontal pairs cannot violate after a run-min).  Held
  over many seeds, shapes (odd h, w = 1, 2, 3, 130), densities, the
  serpentine and planes mid-tail, and against the JAX pass-2 kernel's flag.
* The plans: every row stored exactly once, every vertical pair checked
  exactly once, every cell in exactly one column tile, the wide-row cap and
  its route, the status buffer's size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import scan_merge as jsm
from rustronomy_watershed_tpu_torch.ops import scan_merge as sm
from torch_fields import serpentine

torch.set_num_threads(1)

SHAPES = [(1, 1), (1, 9), (2, 7), (3, 1), (5, 2), (7, 3), (9, 130), (33, 130), (40, 3), (17, 64)]
SMEM_LIMIT = 232448 - 1024  # a block's shared memory on Hopper, less the kernel's static arrays


def _plane(shape, seed, density):
    gen = np.random.default_rng(seed)
    lab = gen.integers(1, 1 << 26, shape)
    if seed % 3 == 0:  # few distinct labels: long equal runs
        lab = gen.integers(1, 5, shape)
    return np.where(gen.random(shape) < density, lab, 0).astype(np.int32)


def _assert_premise(y):
    out, viol = sm.bwd_vh_plain(y)
    assert bool(sm._fine_violations(out)) == bool(sm._fine_vertical_violations(out)) == bool(viol.item())
    return out


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_fused_stencil_premise(shape, seed):
    """On bwd_vh_plain's output the witness is its vertical half, for the
    plane itself and along the fine tail (pass 1, then pass 2, per round)."""
    density = (0.3, 0.6, 0.9, 1.0)[seed % 4]
    y = torch.from_numpy(_plane(shape, seed, density))
    for _ in range(6):
        out = _assert_premise(y)
        _assert_premise(sm.fwd_v_plain(y)[0])
        y = sm.fwd_v_plain(out)[0]


def test_fused_stencil_premise_serpentine_and_jax_flag():
    """Every round of the serpentine's tail, and the JAX pass-2 kernel's own
    flag on a random plane, equal the vertical half."""
    y = torch.from_numpy(serpentine())
    for _ in range(40):
        out = _assert_premise(y)
        y = sm.fwd_v_plain(out)[0]
    plane = _plane((24, 130), 5, 0.7)
    pad = np.zeros((24, 256), np.int32)
    pad[:, :130] = plane
    jout, jflag = jsm._call_round_kernel(
        jsm._bwd_vh_kernel, jnp.asarray(pad), tile=8, interpret=True, col_lo=0, col_hi=129, real_h=24
    )
    jout = torch.from_numpy(np.asarray(jout)[:, :130].copy())
    assert bool(jflag) == bool(sm._fine_vertical_violations(jout))


def _row_steps(h: int, plan: dict):
    """The row spans each block of a ``"ring"`` plan walks, as csrc/scan_round.cu
    row_ring walks them: ``(band, first row, rows, stored)``, from the row
    above the band (the shadow row, computed for the stencil and not stored)
    in steps of at most ``rows_per_step`` rows."""
    g, band = plan["rows_per_step"], plan["band_rows"]
    for b in range(plan["n_bands"]):
        r0, r_end = b * band, min(h, (b + 1) * band)
        a = r0 - 1 if r0 > 0 else 0
        while a < r_end:
            n = min(g, r_end - a)
            yield b, a, n, a >= r0
            a += n


ROW_CASES = [
    (16384, 16384, 132), (4096, 4096, 132), (4096, 2, 132), (4096, 1, 132), (9001, 3, 132),
    (9001, 700, 132), (63, 97, 132), (1, 5, 132), (1, 18432, 132), (2, 18433, 132), (3, 1031, 132),
    (16384, 16384, 114), (1023, 1031, 78), (300, 20000, 132), (5, 9216, 132),
]


@pytest.mark.parametrize("h,w,n_sm", ROW_CASES, ids=[f"{h}x{w}@{n}" for h, w, n in ROW_CASES])
def test_row_plan(h, w, n_sm):
    plan = sm.row_plan(h, w, n_sm)
    if w > sm._ROW_CAP:
        assert plan["route"] == "chunked" and plan["threads"] == 0
        return
    assert plan["route"] == "ring"
    g, band, threads = plan["rows_per_step"], plan["band_rows"], plan["threads"]
    # A step's span fits the ring buffer a thread layout covers, phase included.
    assert 1 <= g <= h and g * w <= sm._ROW_CAP and g * w + 3 <= threads * sm._ROW_CELLS
    assert threads % 32 == 0 and threads <= 1024 and threads - 32 < -(-(g * w + 3) // sm._ROW_CELLS)
    assert plan["smem"] == 3 * threads * sm._ROW_CELLS * 4 <= SMEM_LIMIT
    # Narrow planes take many rows per step; bands are long enough that the
    # shadow row costs little; about one band per SM.
    assert g == min(h, sm._ROW_CAP // w)
    assert band >= min(h, sm._MIN_BAND) and plan["n_bands"] <= max(n_sm, -(-h // sm._MIN_BAND))
    stored = np.zeros(h, np.int64)
    checked = np.zeros(h, np.int64)  # checked[r]: the pair (r-1, r)
    walked = {}
    for b, a, n, own in _row_steps(h, plan):
        assert 1 <= n <= g
        first = b not in walked
        walked[b] = walked.get(b, 0) + n
        rows = np.arange(a, a + n)
        if own:
            stored[rows] += 1
            checked[rows[1:] if first else rows] += 1
        else:  # the shadow row leads its band's first step
            assert first and a == b * band - 1
            stored[rows[1:]] += 1
            checked[rows[1:]] += 1
    assert (stored == 1).all()
    assert checked[0] == 0 and (checked[1:] == 1).all()
    extra = sum(walked.values()) - h
    assert extra == plan["n_bands"] - 1  # one shadow row per band after the first


VSCAN_CASES = [(1, 1, False), (5, 3, False), (128, 128, True), (129, 129, False), (260, 260, True), (300, 32, True)]


@pytest.mark.parametrize("h,w,vec", VSCAN_CASES, ids=[f"{h}x{w}{'v' if v else 's'}" for h, w, v in VSCAN_CASES])
def test_vscan_plan_covers_each_cell_once(h, w, vec):
    plan = sm.vscan_plan(h, w, vec)
    tr, tc = plan["tile_rows"], plan["tile_cols"]
    assert tr == 128 and tc == (128 if vec else 32)
    n_tc = -(-w // tc)
    seen = np.zeros((h, w), np.int64)
    for tile in range(plan["n_tiles"]):  # the kernel's mapping of tile ids
        ti, tj = divmod(tile, n_tc)
        seen[ti * tr : (ti + 1) * tr, tj * tc : (tj + 1) * tc] += 1
    assert (seen == 1).all()
    # A tile's predecessor in the look-back (tile - n_tc) has a smaller id.
    assert plan["status_ints"] == 1 + plan["n_tiles"] * (1 + 2 * tc)


def test_vscan_plan_at_16384():
    plan = sm.vscan_plan(16384, 16384, True)
    assert plan["n_tiles"] == 128 * 128
    # Two carries per column and 128-row tile: the status buffer is 1/64 of a plane.
    assert plan["status_ints"] == 16384 * 16384 // 64 + plan["n_tiles"] + 1
    assert sm.vscan_plan(16384, 16383, False)["tile_cols"] == 32


def test_vec_needs_width_and_alignment():
    x = torch.zeros((4, 8), dtype=torch.int32)
    assert sm._vec(8, x) and not sm._vec(6, x)
    assert not sm._vec(8, torch.zeros(40, dtype=torch.int32)[1:33].view(4, 8))  # one int off its line


COARSE_ROW_CASES = [
    (2048, 4096, 132), (8192, 16384, 132), (1024, 16384, 132), (4501, 700, 132), (512, 3, 132), (1, 5, 132),
    (1, 18432, 132), (2, 18433, 132), (150, 18440, 132), (2048, 4096, 114), (501, 1031, 78),
]


@pytest.mark.parametrize("h,w,n_sm", COARSE_ROW_CASES, ids=[f"{h}x{w}@{n}" for h, w, n in COARSE_ROW_CASES])
def test_row_plan_coarse(h, w, n_sm):
    """The coarse round's h-pass: the ring below the cap, the chunked route
    above; steps of about _COARSE_STEP cells (one row when the row is
    longer), no shadow row, every row stored once, blocks that fit an SM
    together and spread over all of them."""
    plan = sm.row_plan(h, w, n_sm, coarse=True)
    if w > sm._ROW_CAP:
        assert plan["route"] == "chunked" and plan["threads"] == 0
        return
    assert plan["route"] == "ring"
    g, band, threads = plan["rows_per_step"], plan["band_rows"], plan["threads"]
    assert g == min(h, max(1, sm._COARSE_STEP // w))
    assert g * w + 3 <= threads * sm._ROW_CELLS and threads % 32 == 0 and threads <= 1024
    assert threads - 32 < -(-(g * w + 3) // sm._ROW_CELLS)
    assert plan["smem"] == 3 * threads * sm._ROW_CELLS * 4 <= SMEM_LIMIT
    per_sm = min(sm._SM_SMEM // (plan["smem"] + sm._BLOCK_SMEM), sm._SM_THREADS // threads)
    assert per_sm >= 1 and band >= g
    assert plan["n_bands"] <= max(n_sm * per_sm, 1) and plan["n_bands"] == -(-h // band)
    # Bands of whole steps from their own first row: every row once.
    stored = np.zeros(h, np.int64)
    for b in range(plan["n_bands"]):
        stored[b * band : min(h, (b + 1) * band)] += 1
    assert (stored == 1).all()
    assert sm.row_plan(h, w, n_sm)["route"] == "ring"  # the fine plan takes the same route
