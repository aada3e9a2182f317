"""Port parity for the coarse component-min tail (plain twins of
csrc/coarsen.cu, csrc/scan_round.cu and csrc/coarse_broadcast.cu) started
from the JAX merging path's fixed point, against the JAX coarse engine in
Pallas interpret mode.  Integer outputs, tolerance 0."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import pallas_relax as jrelax
from rustronomy_watershed_tpu.ops import scan_merge as jsm
from rustronomy_watershed_tpu.ops.seeds import local_extrema_mask as j_mask
from rustronomy_watershed_tpu.ops.seeds import paint_seeds as j_paint
from rustronomy_watershed_tpu.ops.seeds import seed_labels_from_mask as j_number
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.convert import planes_from_jax
from rustronomy_watershed_tpu_torch.ops import scan_merge as sm

torch.set_num_threads(1)


def _numbered(img):
    return np.array(j_number(j_mask(jnp.asarray(img, jnp.int32))))


# Jitted so that the trials of one shape share a compilation.
_j_fixed_point = jax.jit(
    partial(jrelax.relax_packed_planes, fwd_scan="stats", interpret=True), static_argnames="steps"
)
_j_coarse_tail = jax.jit(
    partial(jsm.component_min_coarse_from_padded, interpret=True), static_argnames=("p", "h", "w", "col_off")
)


def _jax_fixed_point(img, lab0, steps):
    """The JAX merging path's relax state: the padded fixed point of
    relax_packed_planes(fwd_scan='stats') and its label plane carried into a
    port tensor.  Returns ``(lab_pad, p, col_off, lab)``."""
    key_pad, lab_pad, p, col_off, tile = _j_fixed_point(jnp.asarray(img, jnp.int32), jnp.asarray(lab0), steps=steps)[:5]
    p, col_off, tile = int(p), int(col_off), int(tile)
    v_pad = jrelax.pack_domain(img, lab0, tile, p)[0]
    lab = planes_from_jax(v_pad, key_pad, lab_pad, p, col_off, *img.shape, device="cpu")[2]
    return lab_pad, p, col_off, lab


@pytest.mark.parametrize("trial", range(6))
def test_coarse_tail_matches_jax_from_jax_fixed_point(trial):
    """The port's coarse tail started from the JAX fixed point equals JAX
    component_min_coarse_from_padded (tests/test_merge_fast.py:610-657:
    random ranges, sentinel densities up to 60%, painted border/corner
    seeds)."""
    gen = np.random.default_rng(1000 + trial)
    h, w = [(32, 64), (64, 48)][trial % 2]
    hi = int(gen.choice([3, 60, 254]))
    img = gen.integers(0, hi, size=(h, w)).astype(np.uint8)
    img[gen.random((h, w)) < float(gen.choice([0.05, 0.3, 0.6]))] = 255
    if trial % 3:
        coords = sorted({(int(gen.integers(0, h)), int(gen.integers(0, w))) for _ in range(8)})
        coords += [(0, 0), (0, w // 2), (h - 1, w - 1), (h // 2, 0)]
        lab0 = np.asarray(j_paint((h, w), coords))
    else:
        lab0 = _numbered(img)
    lab_pad, p, col_off, lab = _jax_fixed_point(img, lab0, steps=16)
    want = np.asarray(_j_coarse_tail(lab_pad, p=p, h=h, w=w, col_off=col_off))
    _ext.reset_launches()
    got, rounds = sm.component_min_coarse(lab, int(lab0.max()))
    np.testing.assert_array_equal(got.numpy(), want)
    assert rounds >= 1 and _ext.launches["coarse_round_plain"] == rounds
    assert _ext.launches["coarsen_plain"] == _ext.launches["coarse_broadcast_plain"] == 1
    np.testing.assert_array_equal(np.asarray(jsm.component_min_labels(jnp.asarray(lab.numpy()), use_pallas=False)), want)
