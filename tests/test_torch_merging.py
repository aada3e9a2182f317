"""Port parity for the merging main path end to end: ``watershed_e2e(merging=
True)`` against the JAX relax_pallas pipeline (Pallas interpret mode), with
the route the driver took (broadcast shortcut or coarse tail).  Integer
labels, tolerance 0."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops.pipeline import watershed_e2e_impl as j_e2e
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.ops.pipeline import watershed_e2e

torch.set_num_threads(1)


def _field(kind):
    rng = np.random.default_rng(42)
    img = rng.integers(0, 254 if kind == "dense" else 60, size=(48, 56)).astype(np.uint8)
    if kind == "nan_dots":
        img[rng.random(img.shape) < 0.1] = 255
    return img


@pytest.mark.parametrize(
    "kind,maxlvl,route",
    [("dense", 254, "merge_shortcut"), ("nan_dots", 254, "merge_tail"), ("nan_dots", 59, "merge_tail")],
)
def test_merging_e2e_matches_jax_relax_pallas(kind, maxlvl, route):
    img = _field(kind)
    want = np.asarray(
        jax.jit(partial(j_e2e, max_water_level=maxlvl, merging=True, backend="relax_pallas", interpret=True))(
            jnp.asarray(img)
        )
    )
    _ext.reset_launches()
    got, starved = watershed_e2e(img, max_water_level=maxlvl, merging=True, with_flags=True, device="cpu")
    assert got.dtype == torch.int32 and got.shape == img.shape and starved is False
    np.testing.assert_array_equal(got.numpy(), want)
    other = {"merge_shortcut": "merge_tail", "merge_tail": "merge_shortcut"}[route]
    assert _ext.launches[route] == 1 and _ext.launches[other] == 0
    tail = route == "merge_tail"
    assert (_ext.launches["coarsen_plain"], _ext.launches["coarse_broadcast_plain"]) == (tail, tail)
    assert (_ext.launches["coarse_round_plain"] > 0) == tail
    assert sum(_ext.launches[k] for k in _ext.KERNELS) == 0  # no kernel on the CPU
    if route == "merge_shortcut":
        assert (got[1:-1, 1:-1] == 1).all()  # label 1 is the least, row-major


def test_merging_driver_backends_agree():
    """The exact engine + oracle ('relax') and the packed engine + coarse
    tail give the same merged labels from painted seeds, at both depths."""
    img = _field("nan_dots")
    lab0 = np.zeros(img.shape, np.int32)
    coords = [(5, 7), (0, 9), (20, 0), (47, 30), (30, 30), (12, 44)]
    for i, (y, x) in enumerate(coords, 1):
        lab0[y, x] = i
    for maxlvl in (254, 40):
        kw = dict(max_water_level=maxlvl, merging=True, n_labels=len(coords), device="cpu")
        packed = run_levels_impl(img, lab0, backend="packed", **kw)
        exact = run_levels_impl(img, lab0, backend="relax", **kw)
        np.testing.assert_array_equal(packed.numpy(), exact.numpy())
    with pytest.raises(ValueError, match="n_labels"):
        run_levels_impl(img, lab0, max_water_level=254, merging=True, device="cpu")
