"""The launch plans of the pack and coarsen kernels (csrc/pack.cu,
csrc/coarsen.cu), and a NumPy model of the pack kernel's band numbering held
against the plain twin ``pack_plain`` (itself held against the JAX fused pack
kernel in tests/test_torch_pack.py, and here on the seed lattice).

The band kernel numbers seeds row-major without a global pass: each band of
R rows counts its seeds (per row and per 16-column group), takes the
exclusive prefix of the band totals in ticket order by a decoupled look-back
(32 predecessors a step, stopping at the nearest inclusive prefix), and ranks
each seed by row offset, group offset and bit rank.  The model does the same
arithmetic in NumPy.  Integer planes, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops.pallas_pack import pack_domain_fused as j_pack_fused
from rustronomy_watershed_tpu_torch.convert import planes_from_jax
from rustronomy_watershed_tpu_torch.ops import pack
from rustronomy_watershed_tpu_torch.ops import scan_merge as sm
from torch_fields import plateau, seed_lattice

torch.set_num_threads(1)

WIDTHS = [1, 2, 3, 5, 15, 16, 17, 97, 4096, 16384, 70000]
HEIGHTS = [1, 7, 4099, 16384]
SM_REGS, BLOCK_THREADS, GRID_Y = 65536, 1024, 65535


@pytest.mark.parametrize("w", WIDTHS)
def test_pack_plan(w):
    for h in HEIGHTS:
        for aligned in (True, False):
            p = pack.pack_plan(h, w, aligned)
            if w > 16384:
                assert p["route"] == "rows" and p["n_bands"] == h and p["status_words"] * 2 >= h
            else:
                assert p["route"] == ("vec" if w % 16 == 0 and aligned else "bytes")
                assert p["threads"] % 32 == 0 and p["threads"] * 16 >= w > p["threads"] * 16 - 512
                assert p["band_rows"] == 8
                # Bands cover every row once: the last band starts inside the image.
                r = p["band_rows"]
                assert p["n_bands"] * r >= h > (p["n_bands"] - 1) * r
                assert p["status_words"] == 1 + p["n_bands"]
            # The band kernel's registers are held to 64 a thread by its
            # launch bounds (1024 threads, one block an SM): the card refuses
            # the 16384-wide launch in the CUDA tests if they are not.
            assert p["threads"] <= BLOCK_THREADS
    # The main path's shapes take the 16-byte band route.
    for side in (4096, 16384):
        assert pack.pack_plan(side, side, True)["route"] == "vec"


@pytest.mark.parametrize("w", WIDTHS)
def test_coarsen_plan(w):
    for h in HEIGHTS:
        for aligned in (True, False):
            if w < 3:
                with pytest.raises(ValueError):
                    sm.coarsen_plan(h, w, aligned)
                continue
            p = sm.coarsen_plan(h, w, aligned)
            hc = (h + 1) // 2
            gx, gy = p["grid"]
            # 255 registers a thread, the most a thread can hold, still fit.
            assert p["threads"] % 32 == 0 and p["threads"] <= 256 and p["threads"] * 255 <= SM_REGS
            if w % 4 == 0 and aligned:
                assert p["route"] == "vec"
                assert gx * p["threads"] * 4 >= w > (gx - 1) * p["threads"] * 4
                # Strips cover every coarse row once.
                k = p["k_rows"]
                assert gy * k >= hc > (gy - 1) * k and gy <= GRID_Y
            else:
                assert p["route"] == "cells" and gy == 1 and gx * p["threads"] >= hc * w
    p = sm.coarsen_plan(4096, 4096, True)
    assert p["route"] == "vec" and p["k_rows"] == 2 and p["grid"] == (4, 1024)
    assert sm.coarsen_plan(2 * GRID_Y * 3, 16, True)["k_rows"] == 3  # the grid's y axis binds


def _strict_maxima(img):
    a = img.astype(np.int16)
    h, w = a.shape
    m = np.zeros((h, w), bool)
    if h >= 3 and w >= 3:
        c = a[1:-1, 1:-1]
        ok = np.ones_like(c, bool)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    ok &= a[1 + dy : h - 1 + dy, 1 + dx : w - 1 + dx] < c
        m[1:-1, 1:-1] = ok
    return m


def _look_back(aggs, b, inclusive_seen):
    """Band ``b``'s exclusive prefix as the kernel's warp look-back finds
    it: windows of 32 predecessors (nearest first); each holds an aggregate,
    or an inclusive prefix where ``inclusive_seen`` says its band had
    already published one; the walk stops at the nearest inclusive."""
    incl = np.concatenate([[0], np.cumsum(aggs)])  # incl[k + 1]: bands 0..k
    excl = 0
    end = b
    while True:
        ks = [end - 1 - lane for lane in range(32)]
        words = [(2, 0) if k < 0 else (2, int(incl[k + 1])) if inclusive_seen[k] else (1, int(aggs[k])) for k in ks]
        first = next((i for i, (f, _) in enumerate(words) if f == 2), 32)
        excl += sum(v for i, (_, v) in enumerate(words) if i <= first)
        if first < 32:
            return excl
        end -= 32


def band_numbering(img, band_rows, rng):
    """``(lab, n_seeds)`` as the band kernel computes them."""
    mask = _strict_maxima(img)
    h, w = mask.shape
    groups = -(-w // 16)
    padded = np.zeros((h, groups * 16), bool)
    padded[:, :w] = mask
    n_bands = -(-h // band_rows)
    aggs = np.array([mask[b * band_rows : (b + 1) * band_rows].sum() for b in range(n_bands)], np.int64)
    lab = np.zeros((h, groups * 16), np.int32)
    for b in range(n_bands):
        # Which predecessors had published an inclusive prefix when band b
        # looked back: any subset, band 0 always.
        seen = rng.random(b) < 0.3
        if b:
            seen[0] = True
        off = _look_back(aggs, b, seen)
        rows = padded[b * band_rows : (b + 1) * band_rows].reshape(-1, groups, 16)
        cnt = rows.sum(-1)  # (rows, groups)
        assert cnt.sum(-1).max(initial=0) <= 8192 and cnt.max(initial=0) <= 8  # two rows' counts per int
        row_off = np.concatenate([[0], np.cumsum(cnt.sum(-1))[:-1]])
        grp_off = np.cumsum(cnt, -1) - cnt
        bit_rank = np.cumsum(rows, -1)  # inclusive: the seed's own bit counts
        rank = off + row_off[:, None, None] + grp_off[:, :, None] + bit_rank
        lab[b * band_rows : (b + 1) * band_rows] = np.where(rows, rank, 0).reshape(-1, groups * 16)
    return lab[:, :w], int(aggs.sum())


def _uniform(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[rng.random(shape) < 0.1] = 255
    return img


FIELDS = {
    "1x1": lambda: _uniform((1, 1), 0),
    "2x5": lambda: _uniform((2, 5), 1),
    "63x97": lambda: _uniform((63, 97), 2),
    "41x17": lambda: _uniform((41, 17), 3),
    "seed lattice 70x83": lambda: seed_lattice((70, 83), 4),
    "plateau 0..3 90x64": lambda: plateau((90, 64), 5),
    "uniform 200x1030": lambda: _uniform((200, 1030), 6),
}


@pytest.mark.parametrize("band_rows", [4, 8, 16])
@pytest.mark.parametrize("field", list(FIELDS))
def test_band_numbering_model_matches_twin(field, band_rows):
    img = FIELDS[field]()
    lab, n = band_numbering(img, band_rows, np.random.default_rng(band_rows))
    _, _, want_lab, want_n = pack.pack_plain(torch.from_numpy(img))
    np.testing.assert_array_equal(lab, want_lab.numpy())
    assert n == int(want_n)


def test_look_back_over_many_bands():
    """A few thousand bands, every schedule of published prefixes: the
    look-back's exclusive prefix equals the running sum."""
    rng = np.random.default_rng(7)
    aggs = rng.integers(0, 5000, 3000)
    want = np.concatenate([[0], np.cumsum(aggs)[:-1]])
    for b in (0, 1, 31, 32, 33, 64, 2999):
        for p_seen in (0.0, 0.01, 0.5, 1.0):
            seen = rng.random(b) < p_seen
            if b:
                seen[0] = True
            assert _look_back(aggs, b, seen) == want[b]


def test_seed_lattice_matches_jax_fused_kernel():
    """The densest seed plane through the JAX fused pack kernel (interpret
    mode) and the twin."""
    img = seed_lattice((40, 48), 9)
    shape = img.shape
    v_pad, k_pad, l_pad, n = j_pack_fused(jnp.asarray(img), 8, 8, interpret=True)
    want = planes_from_jax(v_pad, k_pad, l_pad, 8, 8, *shape, device="cpu")
    got = pack.pack_plain(torch.from_numpy(img))
    for g, w_ in zip(got[:3], want):
        np.testing.assert_array_equal(g.numpy(), w_.numpy())
    assert int(got[3]) == int(n) == 19 * 23
