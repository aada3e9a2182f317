"""Port parity: the relax kernel's y0 epilogue (``fwd_scan=True``) and the
fine tail's ``y0=`` entry, against the JAX package's fused fixed point
(``relax_packed_planes(fwd_scan=True)`` in interpret mode, band and striped
geometry) and ``component_min_from_padded(y0=, y0_valid=)``.  Integer
outputs, tolerance 0.  A NumPy model of csrc/relax.cu's epilogue (strips,
warps, the tile look-back under any publishing order) is held against the
twin's y0 as well."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.constants import NEVER_FILL
from rustronomy_watershed_tpu.ops import pallas_relax as jrelax
from rustronomy_watershed_tpu.ops import scan_merge as jsm
from rustronomy_watershed_tpu.ops.seeds import local_extrema_mask as j_mask
from rustronomy_watershed_tpu.ops.seeds import paint_seeds as j_paint
from rustronomy_watershed_tpu.ops.seeds import seed_labels_from_mask as j_number
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.constants import _INF
from rustronomy_watershed_tpu_torch.convert import planes_from_jax
from rustronomy_watershed_tpu_torch.ops import relax
from rustronomy_watershed_tpu_torch.ops import scan_merge as sm
from rustronomy_watershed_tpu_torch.ops.ckpt_relax import PlaneSnapshots
from rustronomy_watershed_tpu_torch.ops.pack import pack_domain, pack_plain
from torch_fields import cone_lattice

torch.set_num_threads(1)

CERTIFY, SHORT = 96, 4  # steps at which call 1 certifies every field here / does not


def _numbered(img):
    return np.asarray(j_number(j_mask(jnp.asarray(img, jnp.int32))))


def _stacked(b=3, h=20, w=64):
    """A transform_batch merging plane: ``b`` images of ``h`` x ``w`` with
    NEVER_FILL frames, each followed by a NEVER_FILL row, and painted
    seeds (test_component_shortcut.py's stacked case at width 64)."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 254, size=(b, h, w)).astype(np.uint8)
    imgs[1, 5:9, 6:10] = NEVER_FILL
    imgs[:, 0, :] = imgs[:, -1, :] = NEVER_FILL
    imgs[:, :, 0] = imgs[:, :, -1] = NEVER_FILL
    seeds = [[(3, 4), (h - 4, w - 5), (7, 9)], [(2, 2), (6, 11)], [(4, w - 4), (9, 9), (h - 3, 3)]]
    sep = np.full((b, h + 1, w), NEVER_FILL, np.uint8)
    sep[:, :h] = imgs
    lab = np.zeros((b, h + 1, w), np.int32)
    for i, s in enumerate(seeds):
        lab[i, :h] = np.asarray(j_paint((h, w), s))
    return sep.reshape(-1, w), lab.reshape(-1, w)


def _field(name):
    """``(img, labels0)`` of the named field, as test_component_shortcut.py
    builds its dense, NaN-barrier, border-seed and stacked-batch cases."""
    rng = np.random.default_rng(42)
    if name == "dense":
        img = rng.integers(0, 254, (64, 96)).astype(np.uint8)
    elif name == "nan":
        img = rng.integers(0, 254, (64, 96)).astype(np.uint8)
        img[20:28, 30:50] = NEVER_FILL
    elif name == "border_seed":
        img = rng.integers(0, 254, (48, 64)).astype(np.uint8)
        lab = _numbered(img).copy()
        lab[0, 10] = int(lab.max()) + 1
        return img, lab
    else:
        return _stacked()
    return img, _numbered(img)


def _packed(img, lab0):
    return pack_domain(torch.from_numpy(img.copy()), torch.from_numpy(np.array(lab0, np.int32)))


def _jax_case(name, steps, stripes):
    """The JAX fused fixed point on the field and its tail from y0, as numpy
    and Python values, cropped to the image."""
    img, lab0 = _field(name)
    h, w = img.shape
    k, l, p, col_off, tile, y0, y0_valid, mstats, starved = jrelax.relax_packed_planes(
        img, lab0, steps=steps, interpret=True, fwd_scan=True, stripes=stripes
    )
    tail = jsm.component_min_from_padded(
        l, p=p, h=h, w=w, tile=tile, interpret=True, y0=y0, y0_valid=y0_valid, col_off=col_off
    )
    _, key, lab = planes_from_jax(np.zeros(k.shape, np.int8), k, l, p, col_off, h, w, device="cpu")
    return types.SimpleNamespace(
        key=key, lab=lab, y0=np.asarray(y0)[:h, col_off : col_off + w], y0_valid=bool(y0_valid),
        mstats=tuple(int(m) for m in mstats), starved=bool(starved), tail=np.asarray(tail),
    )


def _port_case(name, steps):
    """The twin's fused fixed point, its first call's output labels and the
    tails with and without y0 (and their ``fwd_v_plain`` counts)."""
    img, lab0 = _field(name)
    first = []
    v, key, lab = _packed(img, lab0)
    out = relax.relax_fixed_point(
        v, key, lab, steps=steps, fwd_scan=True,
        on_call=lambda src, dst, flags, skipped: first or first.append(dst[1].clone()),
    )
    key, lab, starved, mstats, y0, y0_valid = out
    _ext.reset_launches()
    plain, rounds = sm.component_min_fine(lab)
    n_fwd = _ext.launches["fwd_v_plain"]
    _ext.reset_launches()
    y0_in = y0.clone()
    got, rounds_y0 = sm.component_min_fine(lab, y0=y0_in, y0_valid=y0_valid)
    return types.SimpleNamespace(
        key=key, lab=lab, starved=starved, mstats=mstats, y0=y0, y0_valid=y0_valid, first=first[0],
        plain=plain, rounds=rounds, n_fwd=n_fwd, got=got, rounds_y0=rounds_y0,
        n_fwd_y0=_ext.launches["fwd_v_plain"],
    )


@pytest.mark.parametrize("stripes", [None, (2, 128)], ids=["bands", "stripes"])
@pytest.mark.parametrize("steps", [CERTIFY, SHORT])
@pytest.mark.parametrize("name", ["dense", "nan", "border_seed", "batch"])
def test_fused_fixed_point_matches_jax(name, steps, stripes):
    want = _jax_case(name, steps, stripes)
    got = _port_case(name, steps)
    np.testing.assert_array_equal(got.key.numpy(), want.key.numpy())
    np.testing.assert_array_equal(got.lab.numpy(), want.lab.numpy())
    assert got.starved == want.starved
    assert got.y0_valid == want.y0_valid == (steps == CERTIFY)
    # y0 is fwd_v of the first call's labels on both sides, certified or not.
    np.testing.assert_array_equal(got.y0.numpy(), want.y0)
    np.testing.assert_array_equal(got.y0.numpy(), sm.fwd_v_scan(got.first).numpy())
    if got.y0_valid:
        np.testing.assert_array_equal(got.y0.numpy(), sm.fwd_v_scan(got.lab).numpy())
        assert (got.mstats[0], int(got.mstats[1]), got.mstats[2]) == want.mstats
    # The tail: from y0 (one fwd_v fewer) or without it, equal labels and
    # rounds, equal to JAX's tail from its y0.
    np.testing.assert_array_equal(got.got.numpy(), want.tail)
    np.testing.assert_array_equal(got.plain.numpy(), want.tail)
    assert got.rounds_y0 == got.rounds
    assert got.n_fwd_y0 == got.n_fwd - int(got.y0_valid)


@pytest.mark.parametrize("start_sweeps", [0, 5])
def test_twin_y0_is_fwd_v_of_its_output(start_sweeps):
    """Every call's y0 is the fine pass 1 of that call's output labels, and
    fwd_scan implies the statistics (the flags equal a stats=True call's)."""
    img = np.random.default_rng(7).integers(0, 30, (48, 80)).astype(np.uint8)
    v, key, lab, _ = pack_plain(torch.from_numpy(img))
    if start_sweeps:
        key, lab, _ = relax.relax_block_plain(v, key, lab, start_sweeps)
    k2, l2, flags, y0 = relax.relax_block(v, key, lab, 8, fwd_scan=True)
    k3, l3, flags3 = relax.relax_block(v, key, lab, 8, stats=True)
    assert torch.equal(k2, k3) and torch.equal(l2, l3) and flags.tolist() == flags3.tolist()
    assert torch.equal(y0, sm.fwd_v_plain(l2)[0])


def test_fwd_scan_refuses_a_rectangle_and_checkpoints():
    img = np.random.default_rng(1).integers(0, 30, (48, 64)).astype(np.uint8)
    v, key, lab, _ = pack_plain(torch.from_numpy(img))
    with pytest.raises(ValueError, match="rectangle"):
        relax.relax_block(v, key, lab, 8, fwd_scan=True, ctr=(1, 47, 1, 63))
    with pytest.raises(ValueError, match="rectangle"):
        relax.relax_fixed_point(v, key.clone(), lab.clone(), fwd_scan=True, ctr=(0, 48, 0, 64))
    ckpt = PlaneSnapshots(None, "f" * 16)
    with pytest.raises(ValueError, match="checkpoint"):
        relax.relax_packed_planes(img, None, device="cpu", fwd_scan=True, checkpoint=ckpt)


def test_component_min_labels_passes_y0_to_the_fine_tail_only():
    img, lab0 = _field("nan")
    v, key, lab = _packed(img, lab0)
    _, lab, _, _, y0, valid = relax.relax_fixed_point(v, key, lab, steps=CERTIFY, fwd_scan=True)
    assert valid
    want = sm.component_min_labels_plain(lab)
    _ext.reset_launches()
    got, rounds = sm.component_min_labels(lab)  # the fine tail, pass 1 once and after each violated round
    assert torch.equal(got, want) and _ext.launches["fwd_v_plain"] == rounds
    _ext.reset_launches()
    got, rounds_y0 = sm.component_min_labels(lab, y0=y0.clone(), y0_valid=valid)
    assert torch.equal(got, want) and rounds_y0 == rounds and _ext.launches["fwd_v_plain"] == rounds - 1
    _ext.reset_launches()
    got, _ = sm.component_min_labels(lab, max_label=int(lab.max()), y0=y0.clone(), y0_valid=valid)  # coarse
    assert torch.equal(got, want) and _ext.launches["coarsen_plain"] == 1 and _ext.launches["fwd_v_plain"] == 0


@pytest.mark.parametrize("shape", [(64, 96), (130, 70)])
def test_cone_lattice_certifies_in_one_call(shape):
    """chip_smoke.py's certifying field: call 1 of 12 steps certifies (8 do
    not), and the tail from its y0 equals the tail without it."""
    v, key, lab, _ = pack_plain(torch.from_numpy(cone_lattice(shape)))
    calls = []
    out = relax.relax_fixed_point(v, key.clone(), lab.clone(), steps=8, fwd_scan=True, on_call=lambda *a: calls.append(a))
    assert not out[5] and len(calls) == 2
    _, lab2, _, _, y0, valid = relax.relax_fixed_point(v, key, lab, steps=12, fwd_scan=True)
    assert valid
    want, rounds = sm.component_min_fine(lab2)
    got, rounds_y0 = sm.component_min_fine(lab2, y0=y0, y0_valid=valid)
    assert torch.equal(got, want) and rounds_y0 == rounds


# -- a NumPy model of csrc/relax.cu's y0 epilogue -----------------------------

_SEG, _SEGVAL = 1 << 30, (1 << 30) - 1


def _comb(a, b):
    return b if b & _SEG else min(a & _SEGVAL, b) | (a & _SEG)


def _strip_aggregate(col):
    a = _INF
    for c in col:
        a = (_INF | _SEG) if c == 0 else _comb(a, int(c))
    return a


def _y0_kernel_model(lab, steps, warps, rng):
    """y0 as the kernel computes it: tiles of (warps * 8 - 2 steps) x (128 -
    2 steps) centres; a strip of 8 rows a warp; per column the strips'
    aggregates, the tile's aggregate, the look-back over the tiles above
    (each found, at random, with its aggregate only or with its inclusive
    prefix: any order the card may publish in), the strip carries, the
    scan.  Border columns copied through."""
    h, w = lab.shape
    tile_y, tile_x = warps * 8 - 2 * steps, 128 - 2 * steps
    gy, gx = -(-h // tile_y), -(-w // tile_x)
    agg, incl = {}, {}
    y0 = np.zeros_like(lab)
    for ty in range(gy):  # ticket order
        for tx in range(gx):
            for c in range(steps, 128 - steps):
                x = tx * tile_x - steps + c
                if x >= w:
                    continue
                strips = []
                for q in range(warps):
                    rows = [ty * tile_y - steps + yy for yy in range(8 * q, 8 * q + 8)
                            if steps <= yy < 8 * warps - steps and ty * tile_y - steps + yy < h]
                    strips.append((rows, _strip_aggregate(lab[rows, x]) if rows else _INF))
                a = _INF
                for _, s in strips:
                    a = _comb(a, s)
                agg[ty, x] = a
                acc, k = _INF, ty - 1
                while k >= 0 and not acc & _SEG:
                    if rng.random() < 0.5:  # the inclusive prefix is out
                        acc = _comb(incl[k, x], acc)
                        break
                    acc = _comb(agg[k, x], acc)
                    k -= 1
                cin = acc & _SEGVAL
                incl[ty, x] = _comb(cin, a) & _SEGVAL
                for q, (rows, _) in enumerate(strips):
                    f = cin
                    for _, s in strips[:q]:
                        f = _comb(f, s)
                    f &= _SEGVAL
                    for r in rows:
                        c0 = int(lab[r, x])
                        f = _INF if c0 == 0 else min(f, c0)
                        y0[r, x] = c0 if (c0 == 0 or x in (0, w - 1)) else f
    return y0


@pytest.mark.parametrize("shape,steps,warps", [((64, 96), 8, 4), ((61, 300), 3, 2), ((48, 64), 8, 16), ((9, 5), 1, 1)])
def test_kernel_epilogue_model_matches_twin(shape, steps, warps):
    """The kernel's tile, strip and look-back decomposition of the scan gives
    the twin's y0 on planes of many tiles (barriers, runs across tile
    rows, narrow and odd planes)."""
    rng = np.random.default_rng(shape[0])
    lab = np.where(rng.random(shape) < 0.15, 0, rng.integers(1, 1 << 20, shape)).astype(np.int32)
    lab[:, shape[1] // 3] = 0  # a barrier column
    lab[shape[0] // 2 :, 1] = 0  # a long barrier run
    want = sm.fwd_v_scan(torch.from_numpy(lab)).numpy()
    for trial in range(3):
        got = _y0_kernel_model(lab, steps, warps, np.random.default_rng(trial))
        np.testing.assert_array_equal(got, want)
