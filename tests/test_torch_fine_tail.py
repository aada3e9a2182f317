"""Port parity for the fine scan tail: the plain twins of csrc/scan_round.cu's
fine passes (``fwd_v_plain``, ``bwd_vh_plain``) against the JAX kernels
``_fwd_v_kernel`` / ``_bwd_vh_kernel`` in Pallas interpret mode, pass by pass
with their flags; ``component_min_fine`` against the JAX fine tail and the
oracle; and the merging transform with labels bounded at 2**24 (the coarse
gate fails) against the JAX ``relax_pallas`` route.  Integer outputs,
tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import scan_merge as jsm
from rustronomy_watershed_tpu.ops.level_driver import run_levels as j_run_levels
from rustronomy_watershed_tpu.ops.seeds import local_extrema_mask as j_mask
from rustronomy_watershed_tpu.ops.seeds import seed_labels_from_mask as j_number
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import scan_merge as sm
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from torch_fields import serpentine

torch.set_num_threads(1)
TILE = 8


def _plane(shape, seed):
    gen = np.random.default_rng(seed)
    return np.where(gen.random(shape) < 0.3, 0, gen.integers(1, 60, shape)).astype(np.int32)


def _jax_pass(kernel, plane, **kw):
    """One JAX round pass on the plane embedded in its band geometry (rows to
    a multiple of the tile, lanes to a multiple of 128, zero padding);
    returns the cropped plane and the flag."""
    h, w = plane.shape
    pad = np.zeros((-(-h // TILE) * TILE, -(-w // 128) * 128), np.int32)
    pad[:h, :w] = plane
    out, flag = jsm._call_round_kernel(
        kernel, jnp.asarray(pad), tile=TILE, interpret=True, col_lo=0, col_hi=w - 1, **kw
    )
    return np.asarray(out)[:h, :w], int(bool(flag))


CASES = [("40x56", _plane((40, 56), 1)), ("33x130", _plane((33, 130), 2)), ("17x1", _plane((17, 1), 3)),
         ("9x2", _plane((9, 2), 4)), ("serpentine", serpentine())]


@pytest.mark.parametrize("name,plane", CASES, ids=[c[0] for c in CASES])
def test_fine_passes_match_jax_kernels(name, plane):
    """Pass 1 on the plane, pass 2 on the plane itself and on pass 1's
    output, and pass 1 again on that: planes and flags equal JAX's."""
    h = plane.shape[0]
    x = torch.from_numpy(plane)
    y, changed = sm.fwd_v_plain(x)
    want_y, want_changed = _jax_pass(jsm._fwd_v_kernel, plane)
    np.testing.assert_array_equal(y.numpy(), want_y)
    assert changed.tolist() == [want_changed]
    xa = x.clone()  # in place, as the tail runs it: the same plane and flag
    ya, changed_a = sm.fwd_v_plain(xa, out=xa)
    assert ya is xa and torch.equal(ya, y) and changed_a.tolist() == [want_changed]
    for src in (plane, y.numpy()):
        out, viol = sm.bwd_vh_plain(torch.from_numpy(src))
        want_out, want_viol = _jax_pass(jsm._bwd_vh_kernel, src, real_h=h)
        np.testing.assert_array_equal(out.numpy(), want_out)
        assert viol.tolist() == [want_viol]
    y2, changed2 = sm.fwd_v_plain(out)
    want_y2, want_changed2 = _jax_pass(jsm._fwd_v_kernel, out.numpy())
    np.testing.assert_array_equal(y2.numpy(), want_y2)
    assert changed2.tolist() == [want_changed2]


@pytest.mark.parametrize("name,plane", CASES, ids=[c[0] for c in CASES])
def test_component_min_fine_matches_jax_fine_tail(name, plane):
    _ext.reset_launches()
    got, rounds = sm.component_min_fine(torch.from_numpy(plane))
    assert rounds == _ext.launches["bwd_vh_plain"] >= 1
    assert _ext.launches["fwd_v_plain"] == rounds  # the first, then one per violated round
    want = np.asarray(jsm.component_min_labels(jnp.asarray(plane), use_pallas=True, interpret=True, tile=TILE))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sm.component_min_labels_plain(torch.from_numpy(plane)).numpy(), want)
    if name == "serpentine":
        assert rounds > 3  # the witness keeps the loop going across rounds


def test_merging_transform_with_wide_label_bound_runs_fine_tail():
    """n_labels = 2**24 fails the coarse gate: the port's packed merging
    route runs the fine tail and equals JAX run_levels(relax_pallas), whose
    gate routes it to component_min_from_padded."""
    gen = np.random.default_rng(77)
    img = gen.integers(0, 254, (40, 48)).astype(np.uint8)
    img[gen.random(img.shape) < 0.15] = 255
    lab0 = np.array(j_number(j_mask(jnp.asarray(img, jnp.int32))))
    want = np.asarray(
        j_run_levels(jnp.asarray(img, jnp.int32), jnp.asarray(lab0), n_labels=1 << 24, max_water_level=254,
                     merging=True, backend="relax_pallas", interpret=True)
    )
    _ext.reset_launches()
    got = run_levels_impl(img, torch.from_numpy(lab0), max_water_level=254, merging=True, n_labels=1 << 24,
                          backend="packed", device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert _ext.launches["merge_tail"] == 1
    assert _ext.launches["bwd_vh_plain"] >= 1 and _ext.launches["coarsen_plain"] == 0
