"""The merge phase of the port's level sweep (ops/merge.py) against the JAX
package's ops.merge: merge_touching on random label planes with border
labels, resolve_merges and recolour on random LUTs, and touching_pairs.
Integer labels, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import merge as jmerge
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import merge

torch.set_num_threads(1)


def _labels(seed, shape=(40, 48), n=30, fill=0.75):
    """Random blobby label plane: each pixel copies a label drawn per 4x4
    cell, with holes; the border ring keeps its labels (border seeds)."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(1, n + 1, size=(shape[0] // 4 + 1, shape[1] // 4 + 1))
    lab = np.kron(cells, np.ones((4, 4), np.int64))[: shape[0], : shape[1]].astype(np.int32)
    lab[rng.random(shape) > fill] = 0
    return lab


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_touching_matches_jax(seed):
    lab = _labels(seed, fill=0.55 + 0.1 * seed)
    n = int(lab.max())
    want = np.asarray(jmerge.merge_touching(jnp.asarray(lab), n))
    _ext.reset_launches()
    got = merge.merge_touching(torch.from_numpy(lab), n)
    assert got.dtype == torch.int32 and _ext.launches["merge_round"] >= 1
    np.testing.assert_array_equal(got.numpy(), want)


def test_merge_touching_border_seeds_and_chain():
    lab = np.zeros((6, 9), np.int32)
    lab[0, 3], lab[1, 3] = 7, 2  # border seed over an interior centre: merges
    lab[0, 5], lab[0, 6] = 4, 5  # two border pixels side by side: never pair
    lab[3, 1:7] = [9, 1, 8, 3, 6, 6]  # a chain
    lab[5, 8], lab[4, 8] = 3, 2  # two border pixels in the last column
    for n in (9, 12):
        want = np.asarray(jmerge.merge_touching(jnp.asarray(lab), n))
        got = merge.merge_touching(torch.from_numpy(lab), n).numpy()
        np.testing.assert_array_equal(got, want)
    assert got[0, 3] == 2 and got[0, 5] == 4 and got[0, 6] == 5 and (got[3, 1:7] == 1).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_merges_and_recolour_match_jax(seed):
    rng = np.random.default_rng(seed)
    cmap = rng.integers(0, 40, size=40)
    pairs = rng.integers(1, 40, size=(25, 2))
    want = np.asarray(jmerge.resolve_merges(cmap, pairs))
    got = merge.resolve_merges(torch.from_numpy(cmap), torch.from_numpy(pairs))
    np.testing.assert_array_equal(got.numpy(), want)
    lab = rng.integers(0, 40, size=(9, 11)).astype(np.int32)
    np.testing.assert_array_equal(
        merge.recolour(torch.from_numpy(lab), got).numpy(),
        np.asarray(jmerge.recolour(jnp.asarray(lab), jnp.asarray(want))),
    )


def test_resolve_merges_reference_cases():
    """The reference's test_make_colour_map (src/lib.rs:544-587)."""
    ident = np.arange(10)
    for pairs, want in (
        ([[1, 2]], [0, 1, 1, 3, 4, 5, 6, 7, 8, 9]),
        ([[9, 8], [2, 1]], [0, 1, 1, 3, 4, 5, 6, 7, 8, 8]),
        ([[2, 3], [1, 2]], [0, 1, 1, 1, 4, 5, 6, 7, 8, 9]),
        ([], list(range(10))),
    ):
        got = merge.resolve_merges(torch.from_numpy(ident), torch.tensor(pairs, dtype=torch.int64))
        assert got.tolist() == want == np.asarray(jmerge.resolve_merges(ident, np.asarray(pairs).reshape(-1, 2))).tolist()


def test_touching_pairs_matches_jax():
    lab = _labels(5, shape=(12, 14), n=9)
    assert merge.touching_pairs(lab) == jmerge.touching_pairs(lab)
