"""The port's copies of the JAX package's host oracles
(``rustronomy_watershed_tpu_torch.parity``: the NumPy level loop
``oracle.py`` and the event-driven ``heap_oracle.py``) against the JAX
package's, and the NumPy oracle against the port's CPU transform.
Tolerance 0.

Every field of ``golden_v1.npz`` (both variants, the final labels and every
per-level snapshot; the edge-corrected merging case), seeded random fields,
and the heap oracle at <= 64².
"""

import functools
import os

import numpy as np
import pytest

from rustronomy_watershed_tpu import parity as j_parity
from rustronomy_watershed_tpu.parity import heap_oracle as j_heap
from rustronomy_watershed_tpu_torch import parity
from rustronomy_watershed_tpu_torch.parity import heap_oracle
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden", "golden_v1.npz"))
GOLDEN_FIELDS = ["uniform", "poisson", "grf", "nanmasked"]
VARIANTS = ["segmenting", "merging"]
# (shape, value range, water level) of the seeded random fields.
RANDOM = {"20x24 hi 12": ((20, 24), 12, 254), "17x31 hi 40 lvl 20": ((17, 31), 40, 20), "32x32 hi 4": ((32, 32), 4, 254)}


def _golden(field):
    return GOLDEN[f"{field}/img"], [tuple(int(c) for c in s) for s in GOLDEN[f"{field}/seeds"]]


@functools.lru_cache(maxsize=None)
def _port_oracle(field, merging, edge=False):
    """The port's ``oracle_transform`` of a golden field at full depth."""
    img, seeds = _golden(field)
    if edge:
        seeds = [tuple(int(c) for c in s) for s in GOLDEN["edge/seeds"]]
    return parity.oracle_transform(img, seeds, 254, merging=merging, edge_correction=edge)


def _random(name, seed=0):
    (h, w), hi, lvl = RANDOM[name]
    rng = np.random.default_rng(seed + h * 100 + w)
    img = rng.integers(0, hi, (h, w)).astype(np.uint8)
    img[rng.random((h, w)) < 0.05] = 255
    return img, lvl


def _same_run(got, want):
    """Equal ``(labels, snapshots)``, every snapshot included."""
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)


def test_exports_equal_jax():
    assert parity.__all__ == j_parity.__all__
    assert parity.oracle_transform.__module__ == "rustronomy_watershed_tpu_torch.parity.oracle"


def test_importing_parity_builds_nothing():
    """``parity/__init__.py`` leaves ``native`` (the C++ engine's binding)
    out, as the JAX package's does: importing ``parity`` builds no engine
    and imports no JAX."""
    import subprocess
    import sys

    code = ("import sys; import rustronomy_watershed_tpu_torch.parity as p; "
            "from rustronomy_watershed_tpu_torch.parity import native; "
            "assert native._lib is None; "
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("field", GOLDEN_FIELDS)
def test_oracle_transform_on_golden_equals_jax(field, variant):
    """Final labels and all 255 snapshots == JAX's oracle; the final labels
    == the golden's."""
    img, seeds = _golden(field)
    got = _port_oracle(field, variant == "merging")
    _same_run(got, j_parity.oracle_transform(img, seeds, 254, merging=variant == "merging"))
    assert len(got[1]) == 255
    np.testing.assert_array_equal(got[0], GOLDEN[f"{field}/{variant}/labels"])


def test_oracle_transform_edge_golden_equals_jax():
    img, _ = _golden("uniform")
    seeds = [tuple(int(c) for c in s) for s in GOLDEN["edge/seeds"]]
    got = _port_oracle("uniform", True, edge=True)
    _same_run(got, j_parity.oracle_transform(img, seeds, 254, merging=True, edge_correction=True))
    np.testing.assert_array_equal(got[0], GOLDEN["edge/merging/labels"])


@pytest.mark.parametrize("field", GOLDEN_FIELDS)
def test_oracle_find_local_minima_on_golden_equals_jax(field):
    img, seeds = _golden(field)
    got = parity.oracle_find_local_minima(img)
    assert got == j_parity.oracle_find_local_minima(img) == seeds


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(RANDOM))
def test_oracles_on_random_fields_equal_jax_and_the_cpu_transform(name, variant):
    """Seeded random fields with NEVER_FILL dots: seeds and every snapshot
    == JAX's oracle; the final labels == the port's CPU transform."""
    img, lvl = _random(name)
    seeds = parity.oracle_find_local_minima(img)
    assert seeds == j_parity.oracle_find_local_minima(img) and seeds
    merging = variant == "merging"
    got = parity.oracle_transform(img, seeds, lvl, merging=merging)
    _same_run(got, j_parity.oracle_transform(img, seeds, lvl, merging=merging))
    tb = TransformBuilder().set_device("cpu").set_max_water_lvl(lvl)
    ws = getattr(tb, f"build_{variant}")()
    assert ws.find_local_minima(img) == seeds
    np.testing.assert_array_equal(ws.transform(img, seeds), got[0])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("field", GOLDEN_FIELDS)
def test_oracle_equals_the_cpu_transform_on_golden(field, variant):
    img, seeds = _golden(field)
    ws = getattr(TransformBuilder().set_device("cpu"), f"build_{variant}")()
    np.testing.assert_array_equal(ws.transform(img, seeds), _port_oracle(field, variant == "merging")[0])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", ["golden uniform 64^2", "golden nanmasked 64^2", "random 17x31 edge"])
def test_heap_oracle_equals_jax(case, variant):
    """``heap_transform`` (labels and the per-level size curves) and
    ``heap_find_local_minima`` == the JAX package's, at <= 64²."""
    edge = case.endswith("edge")
    merging = variant == "merging"
    if case.startswith("golden"):
        img, _ = _golden(case.split()[1])
        oracle = _port_oracle(case.split()[1], merging)[0]
    else:
        img, _ = _random("17x31 hi 40 lvl 20")
        oracle = None
    seeds = heap_oracle.heap_find_local_minima(img)
    assert seeds == j_heap.heap_find_local_minima(img)
    got = heap_oracle.heap_transform(img, seeds, 254, merging=merging, edge_correction=edge, with_sizes=True)
    want = j_heap.heap_transform(img, seeds, 254, merging=merging, edge_correction=edge, with_sizes=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(heap_oracle.heap_transform(img, seeds, 254, merging=merging, edge_correction=edge),
                                  got[0])
    if oracle is None:
        oracle = parity.oracle_transform(img, seeds, 254, merging=merging, edge_correction=edge)[0]
    np.testing.assert_array_equal(got[0], oracle)
