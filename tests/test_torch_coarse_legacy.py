"""Port parity for the legacy two-pass coarse rounds (``RWT_COARSE_MULTI=0``):
the plain twins of csrc/scan_round.cu's coarse passes (``cfwd_v_plain``,
``cbwd_vh_plain``) against the JAX kernels ``_cfwd_v_kernel`` /
``_cbwd_vh_kernel`` in Pallas interpret mode, full width and windowed, flags
included; the legacy schedule against the JAX legacy schedule and against the
port's default schedule; and the parsing of ``RWT_COARSE_HWIN``.  Integer
outputs, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import scan_merge as jsm
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import relax
from rustronomy_watershed_tpu_torch.ops import scan_merge as sm

torch.set_num_threads(1)
TILE = 8
EMPTY = 0xF << sm._CB_VF  # an empty coarse cell: every reset bit set


def _labels(shape, nan, seed):
    """A relaxed label plane (the merging tail's input) of a NaN-dot field."""
    gen = np.random.default_rng(seed)
    img = gen.integers(0, 254, shape).astype(np.uint8)
    img[gen.random(shape) < nan] = 255
    return relax.relax_packed_planes(img, None, device="cpu")[1]


def _jax_pass(kernel, c, **kw):
    """One JAX legacy pass on the coarse plane embedded in its band geometry;
    the padding cells are empty cells with every reset bit set, as the JAX
    coarsen kernel writes them.  Returns the cropped plane and the flag."""
    hc, w = c.shape
    pad = np.full((-(-hc // TILE) * TILE, -(-w // 128) * 128), EMPTY, np.int32)
    pad[:hc, :w] = c
    out, flag = jsm._call_round_kernel(kernel, jnp.asarray(pad), tile=TILE, interpret=True, **kw)
    return np.asarray(out)[:hc, :w], int(bool(flag))


@pytest.fixture(scope="module")
def coarse_plane():
    return sm.coarsen_plain(_labels((40, 700), 0.02, 5))


@pytest.mark.parametrize("h_window", [None, 256, 300])
def test_legacy_passes_match_jax_kernels(coarse_plane, h_window):
    """cfwd_v and cbwd_vh against the JAX kernels; 256 and 300 lanes bind on
    a 700-wide plane (reach 255 and 511 cells, the doubling's reach)."""
    c = coarse_plane
    y, changed = sm.cfwd_v_plain(c)
    want_y, want_changed = _jax_pass(jsm._cfwd_v_kernel, c.numpy())
    np.testing.assert_array_equal(y.numpy(), want_y)
    assert changed.tolist() == [want_changed] == [1]
    for src in (c, y):
        out, viol = sm.cbwd_vh_plain(src, h_window)
        want_out, want_viol = _jax_pass(jsm._cbwd_vh_kernel, src.numpy(), h_window=h_window)
        np.testing.assert_array_equal(out.numpy(), want_out)
        assert viol.tolist() == [want_viol]
    if h_window is not None:  # the window binds: the pass differs from full width
        assert not torch.equal(out, sm.cbwd_vh_plain(y)[0])


def test_window_reach():
    assert sm._reach(700, None) == -1
    assert sm._reach(700, 256) == 255
    assert sm._reach(700, 300) == 511
    assert sm._reach(700, 2) == 1
    assert sm._reach(200, 256) == -1  # the window covers the line
    assert sm._reach(256, 256) == -1


@pytest.mark.parametrize("shape,nan,seed", [((48, 160), 0.15, 1), ((61, 700), 0.05, 2), ((20, 3), 0.1, 3)])
def test_legacy_schedule_matches_jax_and_default(monkeypatch, shape, nan, seed):
    """RWT_COARSE_MULTI=0 in both packages (tests/test_merge_fast.py:779-815):
    the port's legacy schedule equals the JAX legacy schedule and the port's
    default schedule, and launches only the legacy twins."""
    lab = _labels(shape, nan, seed)
    monkeypatch.setattr(sm, "_COARSE_MULTI", True)
    default, _ = sm.component_min_coarse(lab, sm._CVAL)
    monkeypatch.setattr(sm, "_COARSE_MULTI", False)
    monkeypatch.setattr(jsm, "_COARSE_MULTI", False)
    _ext.reset_launches()
    got, rounds = sm.component_min_coarse(lab, sm._CVAL)
    assert rounds == _ext.launches["cbwd_vh_plain"] == _ext.launches["cfwd_v_plain"] >= 1
    assert _ext.launches["coarse_round_plain"] == 0 and _ext.launches["coarsen_plain"] == 1
    want = np.asarray(jsm.component_min_labels(jnp.asarray(lab.numpy()), use_pallas=True, interpret=True,
                                               max_label=sm._CVAL))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(default.numpy(), want)
    np.testing.assert_array_equal(sm.component_min_labels_plain(lab).numpy(), want)


@pytest.mark.parametrize(
    "raw,want", [(None, 256), ("256", 256), ("300", 300), ("2", 2), ("0", None), ("off", None), ("", None)]
)
def test_coarse_hwin_parsing_matches_jax(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("RWT_COARSE_HWIN", raising=False)
    else:
        monkeypatch.setenv("RWT_COARSE_HWIN", raw)
    assert sm._parse_coarse_hwin() == jsm._parse_coarse_hwin() == want


@pytest.mark.parametrize("raw", ["1", "-4"])
def test_coarse_hwin_below_two_raises(monkeypatch, raw):
    monkeypatch.setenv("RWT_COARSE_HWIN", raw)
    with pytest.raises(ValueError, match="need >= 2 lanes"):
        sm._parse_coarse_hwin()
    with pytest.raises(ValueError, match="need >= 2 lanes"):
        jsm._parse_coarse_hwin()


def test_coarse_defaults():
    assert sm._COARSE_HWIN == jsm._COARSE_HWIN == 256
    assert sm._COARSE_MULTI is jsm._COARSE_MULTI is True
