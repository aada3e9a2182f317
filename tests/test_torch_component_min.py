"""Port parity for the component-min stage on label planes: the oracle
against the JAX jnp oracle, the coarse tail's twins (csrc/coarsen.cu,
csrc/scan_round.cu, csrc/coarse_broadcast.cu) on odd heights and narrow
planes against the JAX coarse engine (Pallas interpret mode), the coarse
bits by hand, and the driver's gates.  Integer outputs, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import scan_merge as jsm
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import scan_merge as sm

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(31, 40), (17, 3), (1, 9), (2, 5), (5, 3)])
def test_coarse_tail_odd_height_and_narrow(shape):
    """Odd h (the last coarse row's bottom half lies outside the image) and
    w = 3 (columns 1 and w-2 coincide), against the JAX coarse engine, which
    pads such planes itself, and the JAX oracle."""
    gen = np.random.default_rng(shape[0] * 100 + shape[1])
    lab = np.where(gen.random(shape) < 0.35, 0, gen.integers(1, 40, shape)).astype(np.int32)
    want = np.asarray(jsm.component_min_labels(jnp.asarray(lab), use_pallas=False))
    got, _ = sm.component_min_coarse(torch.from_numpy(lab), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    if shape[0] >= 16:  # the JAX coarse kernels' band geometry
        j_coarse = jsm.component_min_labels(jnp.asarray(lab), use_pallas=True, interpret=True, max_label=64)
        np.testing.assert_array_equal(np.asarray(j_coarse), want)


def test_coarsen_bits_on_a_small_plane():
    """Coarse values, border folds and the four reset bits by hand."""
    lab = torch.tensor(
        [
            [0, 0, 0, 0],
            [7, 5, 0, 0],
            [0, 5, 9, 4],
            [0, 0, 9, 0],
            [3, 2, 0, 0],
        ],
        dtype=torch.int32,
    )
    c = sm.coarsen_plain(lab)
    val = (c & sm._CVAL).tolist()
    # Row pair (0, 1): column 1 folds the claimed border cell (1, 0) = 7 into
    # min(5, 7) = 5; border columns are empty.  Pair (2, 3): column 2 folds
    # (2, 3) = 4.  Pair (4, -): fine row 4 = h-1 is a border row: no fold.
    assert val == [[0, 5, 0, 0], [0, 5, 4, 0], [0, 2, 0, 0]]
    bit = lambda b: ((c >> b) & 1).tolist()  # noqa: E731
    assert bit(sm._CB_VF)[1] == [1, 0, 1, 1]  # (1,1)-(2,1) both claimed
    assert bit(sm._CB_VB)[0] == [1, 0, 1, 1]
    assert bit(sm._CB_VB)[1] == [1, 1, 1, 1]  # row 3 / row 4 never both claimed
    assert bit(sm._CB_HF)[1] == [1, 1, 0, 1]  # (2,1)-(2,2) top halves claimed
    assert bit(sm._CB_HB)[1] == [1, 0, 1, 1]
    assert bit(sm._CB_HF)[2] == [1, 1, 1, 1]  # row 4 is a blocked border row


@pytest.mark.parametrize("seed", range(4))
def test_component_min_oracle_matches_jax(seed):
    gen = np.random.default_rng(seed)
    shape = [(1, 1), (6, 8), (23, 37), (40, 17)][seed]
    lab = np.where(gen.random(shape) < 0.3, 0, gen.integers(1, 50, shape)).astype(np.int32)
    want = np.asarray(jsm.component_min_labels(jnp.asarray(lab), use_pallas=False))
    np.testing.assert_array_equal(sm.component_min_labels_plain(torch.from_numpy(lab)).numpy(), want)


def test_component_min_oracle_blocked_border_edges():
    """tests/test_merge_fast.py:72: two seeds adjacent along the top border
    never merge; joined through interior pixels they do."""
    lab = np.zeros((6, 8), np.int32)
    lab[0, 3], lab[0, 4] = 5, 9
    out = sm.component_min_labels_plain(torch.from_numpy(lab)).numpy()
    assert out[0, 3] == 5 and out[0, 4] == 9
    lab2 = np.zeros((6, 8), np.int32)
    lab2[0, 3], lab2[1, 3], lab2[1, 4], lab2[0, 4] = 5, 5, 9, 9
    out2 = sm.component_min_labels_plain(torch.from_numpy(lab2)).numpy()
    assert (out2[lab2 > 0] == 5).all()
    for a in (lab, lab2):
        want = np.asarray(jsm.component_min_labels(jnp.asarray(a), use_pallas=False))
        np.testing.assert_array_equal(sm.component_min_labels_plain(torch.from_numpy(a)).numpy(), want)
        np.testing.assert_array_equal(sm.component_min_coarse(torch.from_numpy(a), 9)[0].numpy(), want)


def test_coarse_gates_and_dispatch():
    """``component_min_labels`` holds the gate: a failed one (w < 3, or
    labels up to 2**24) runs the fine tail's twins (no coarse twin launches)
    and equals JAX, while the coarse engine itself refuses such a plane; a
    gate that holds runs the coarse twins; on the CPU no kernel launches."""
    lab = torch.tensor([[3, 0], [3, 4], [0, 4]], dtype=torch.int32)
    _ext.reset_launches()
    got, rounds = sm.component_min_labels(lab, max_label=4)  # w = 2
    assert rounds >= 1 and _ext.launches["bwd_vh_plain"] == rounds and _ext.launches["coarsen_plain"] == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsm.component_min_labels(jnp.asarray(lab.numpy()), use_pallas=False)))
    wide = torch.ones((4, 5), dtype=torch.int32)
    wide[2, 3] = 2
    _ext.reset_launches()
    got, rounds = sm.component_min_labels(wide, max_label=1 << 24)  # labels too wide
    assert rounds >= 1 and _ext.launches["fwd_v_plain"] >= 1 and _ext.launches["coarsen_plain"] == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsm.component_min_labels(jnp.asarray(wide.numpy()), use_pallas=False)))
    _ext.reset_launches()
    got, rounds = sm.component_min_labels(wide, max_label=2)
    assert rounds >= 1 and _ext.launches["coarse_round_plain"] == rounds and _ext.launches["fwd_v_plain"] == 0
    assert sum(_ext.launches[k] for k in _ext.KERNELS) == 0
    with pytest.raises(ValueError, match="w >= 3"):
        sm.coarsen_plain(lab)
    with pytest.raises(ValueError, match="w >= 3"):
        sm.component_min_coarse(lab, 4)
    with pytest.raises(ValueError, match="below 2\\*\\*24"):
        sm.component_min_coarse(wide, 1 << 24)


@pytest.mark.parametrize("trial", range(12))
def test_merging_transform_fuzz_against_cxx_oracle(trial):
    """The port's merging transform on the packed engine (coarse tail twins,
    or the shortcut) against the repository's C++ level-loop oracle
    (parity/oracle.cc): random ranges, NaN-dot densities up to 60%, painted
    seeds including border and corner cells, full and cut depths."""
    native = pytest.importorskip("rustronomy_watershed_tpu.parity.native")
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    gen = np.random.default_rng(2000 + trial)
    h, w = int(gen.integers(3, 60)), int(gen.integers(3, 60))
    img = gen.integers(0, int(gen.choice([3, 60, 254])), size=(h, w)).astype(np.uint8)
    img[gen.random((h, w)) < float(gen.choice([0.0, 0.05, 0.3, 0.6]))] = 255
    seeds = [(int(gen.integers(0, h)), int(gen.integers(0, w))) for _ in range(int(gen.integers(1, 12)))]
    seeds += [(0, 0), (h - 1, w // 2)] if trial % 2 else []
    maxlvl = 254 if trial % 3 else int(gen.integers(1, 254))
    ws = TransformBuilder.default().set_device("cpu").set_max_water_lvl(maxlvl).build_merging()
    want = native.native_transform(img, seeds, maxlvl, merging=True)
    np.testing.assert_array_equal(ws.transform(img, seeds), want)
