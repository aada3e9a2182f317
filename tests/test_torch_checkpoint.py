"""Checkpoint / resume (utils/checkpoint.py, ops/ckpt_relax.py): the packed
engine's plane snapshots and the host loop's per-level snapshots against
the JAX package (``ckpt_transform`` in Pallas interpret mode, its host loop)
and the port's uncheckpointed transform, interrupted runs resumed, and the
two faults of the JAX checkpointer the port does not copy: ``latest`` on a
directory that also holds plane snapshots, and a snapshot of another image
of the same shape.  Integer labels, tolerance 0."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import paint_seeds
from rustronomy_watershed_tpu.ops.ckpt_relax import ckpt_transform as j_ckpt_transform
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu.utils.checkpoint import TransformCheckpointer as JaxCheckpointer
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.convert import builder_from_jax
from rustronomy_watershed_tpu_torch.ops import relax
from rustronomy_watershed_tpu_torch.ops.ckpt_relax import ckpt_transform, plane_fingerprint
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
from rustronomy_watershed_tpu_torch.utils.checkpoint import TransformCheckpointer, fingerprint

torch.set_num_threads(1)

SEEDS = [(3, 3), (40, 60), (20, 40), (44, 10), (0, 7)]


def _field(seed, shape=(48, 64), hi=60):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, hi, size=shape).astype(np.uint8)
    img[rng.random(shape) < 0.1] = 255  # NaN lacing: several relax calls
    return img


def _lab0(img, seeds=SEEDS):
    return np.array(paint_seeds(img.shape, seeds))


def _plain(img, lab0, merging, maxlvl=254):
    return run_levels_impl(torch.from_numpy(img), torch.from_numpy(lab0), max_water_level=maxlvl, merging=merging,
                           n_labels=len(SEEDS), backend="packed", device="cpu")


def _ckpt(img, lab0, merging, ckpt, maxlvl=254, **kw):
    labels, starved = ckpt_transform(torch.from_numpy(img), torch.from_numpy(lab0), merging=merging,
                                     n_labels=len(SEEDS), max_water_level=maxlvl, checkpointer=ckpt,
                                     device="cpu", **kw)
    assert starved is False
    return labels


@pytest.mark.parametrize("maxlvl", [254, 40])
@pytest.mark.parametrize("merging", [False, True])
def test_fast_path_matches_jax_and_plain(tmp_path, merging, maxlvl):
    img = _field(1)
    lab0 = _lab0(img)
    want, _ = j_ckpt_transform(jnp.asarray(img), jnp.asarray(lab0), merging=merging, n_labels=len(SEEDS),
                               max_water_level=maxlvl, checkpointer=JaxCheckpointer(tmp_path / "jax", every=1),
                               interpret=True)
    got = _ckpt(img, lab0, merging, TransformCheckpointer(tmp_path / "port", every=1), maxlvl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, _plain(img, lab0, merging, maxlvl))
    assert [p.name.split("-")[0] for p in (tmp_path / "port").iterdir()] == ["planes"]


@pytest.mark.parametrize("interrupt,every", [(1, 1), (3, 1), (3, 2), (5, 4)])
@pytest.mark.parametrize("merging", [False, True])
def test_interrupt_resume_equals_uninterrupted(tmp_path, merging, interrupt, every):
    """steps=2 makes the fixed point take many calls, so every interrupt
    lands mid-transform; the resumed run starts at the snapshot."""
    img = _field(2)
    lab0 = _lab0(img)
    _ext.reset_launches()
    want = _ckpt(img, lab0, merging, None, steps=2)
    total = _ext.launches["relax_plain"]
    assert total > interrupt + 1
    with pytest.raises(RuntimeError, match=f"forced interrupt after {interrupt} calls"):
        _ckpt(img, lab0, merging, TransformCheckpointer(tmp_path, every=every), steps=2,
              _interrupt_after_calls=interrupt)
    fp = plane_fingerprint(torch.from_numpy(img), lab0, merging=merging, max_water_level=254, steps=2, d_bits=23)
    snap = TransformCheckpointer(tmp_path).latest_planes(fp)
    assert snap["calls"] == interrupt // every * every
    _ext.reset_launches()
    got = _ckpt(img, lab0, merging, TransformCheckpointer(tmp_path, every=1000), steps=2)
    assert torch.equal(got, want)
    assert _ext.launches["relax_plain"] == total - snap["calls"]


def test_latest_skips_plane_snapshots(tmp_path):
    """Fault (a): the JAX checkpointer's latest() raises KeyError when the
    newest snapshot in its directory holds planes; the port's returns the
    newest per-level snapshot and latest_planes() the plane snapshot."""
    labels = np.arange(12, dtype=np.int32).reshape(3, 4)
    key, lab = np.full((3, 4), 7, np.int32), np.full((3, 4), 9, np.int32)
    jax_ckpt = JaxCheckpointer(tmp_path / "jax", every=1)
    jax_ckpt.maybe_save(0, labels)
    jax_ckpt.save_planes(3, key, lab, np.ones(1, np.int32), np.zeros(1, np.int32), meta=[3, 4, 8, 8])
    jax_ckpt.wait()
    with pytest.raises(KeyError):
        jax_ckpt.latest()

    fp = fingerprint(labels, labels, run="a")
    ckpt = TransformCheckpointer(tmp_path / "port", every=4)
    assert ckpt.latest(fp) is None and ckpt.latest_planes(fp) is None
    assert ckpt.maybe_save(4, labels, fp) and not ckpt.maybe_save(5, labels + 1, fp)
    assert ckpt.save_planes(3, torch.from_numpy(key), lab, fp) == 2 * key.nbytes
    assert ckpt.maybe_save(8, labels + 2, fp)
    lvl, got = ckpt.latest(fp)
    assert lvl == 8 and got.dtype == np.int32
    np.testing.assert_array_equal(got, labels + 2)
    snap = ckpt.latest_planes(fp)
    assert snap["calls"] == 3
    np.testing.assert_array_equal(snap["key"], key)
    np.testing.assert_array_equal(snap["lab"], lab)
    other = fingerprint(labels, labels, run="b")
    assert ckpt.latest(other) is None and ckpt.latest_planes(other) is None
    ckpt.wait()


def test_fingerprint_covers_image_seeds_and_settings():
    img, lab0 = _field(3, (8, 9)), _lab0(_field(3, (8, 9)), [(2, 2)])
    base = fingerprint(img, lab0, merging=True, steps=8)
    assert base == fingerprint(torch.from_numpy(img), torch.from_numpy(lab0), steps=8, merging=True)
    img2 = img.copy()
    img2[4, 4] ^= 1
    lab2 = lab0.copy()
    lab2[5, 5] = 2
    assert len({
        base, fingerprint(img2, lab0, merging=True, steps=8), fingerprint(img, lab2, merging=True, steps=8),
        fingerprint(img, lab0, merging=False, steps=8), fingerprint(img, lab0, merging=True, steps=4),
        fingerprint(img[:, :-1], lab0[:, :-1], merging=True, steps=8),
        fingerprint(img.reshape(9, 8), lab0.reshape(9, 8), merging=True, steps=8),
    }) == 7


@pytest.mark.parametrize("merging", [False, True])
def test_stale_snapshot_of_another_image_ignored(tmp_path, merging):
    """Fault (b): the JAX fast path resumes any plane snapshot of the same
    geometry.  Here image A's snapshot, under A's name or copied to B's, is
    not resumed for image B of the same shape, and B's labels are right;
    resuming A's planes would have given B wrong labels."""
    img_a, img_b = _field(4), _field(5)
    lab0 = _lab0(img_a)
    with pytest.raises(RuntimeError, match="forced interrupt"):
        _ckpt(img_a, lab0, merging, TransformCheckpointer(tmp_path, every=1), steps=2, _interrupt_after_calls=3)
    (snap_a,) = tmp_path.iterdir()
    fp_b = plane_fingerprint(img_b, lab0, merging=merging, max_water_level=254, steps=2, d_bits=23)
    want = _plain(img_b, lab0, merging)
    for copied in (False, True):
        if copied:
            (tmp_path / f"planes-{fp_b}.npz").write_bytes(snap_a.read_bytes())
        _ext.reset_launches()
        got = _ckpt(img_b, lab0, merging, TransformCheckpointer(tmp_path, every=1000), steps=2)
        assert torch.equal(got, want)
    # The snapshot has teeth: B's relaxation started from A's planes.
    with np.load(snap_a) as z:
        v = torch.from_numpy(img_b.copy())
        v[[0, -1], :] = 255
        v[:, [0, -1]] = 255
        _, stale, _ = relax.relax_fixed_point(v, torch.from_numpy(z["key"]), torch.from_numpy(z["lab"]), steps=2)
    assert not torch.equal(stale, _plain(img_b, lab0, False))


def test_unreadable_snapshot_ignored(tmp_path):
    img = _field(6)
    lab0 = _lab0(img)
    fp = plane_fingerprint(img, lab0, merging=False, max_water_level=254, steps=8, d_bits=23)
    (tmp_path / f"planes-{fp}.npz").write_bytes(b"torn")
    with pytest.warns(RuntimeWarning, match="unreadable snapshot"):
        got = _ckpt(img, lab0, False, TransformCheckpointer(tmp_path, every=1))
    assert torch.equal(got, _plain(img, lab0, False))


@pytest.mark.parametrize("variant", ["segmenting", "merging"])
def test_public_fast_path(tmp_path, variant):
    """set_checkpoint alone on 'auto' snapshots relax planes (no host loop)
    and gives the plain transform's labels; a second run resumes from the
    last snapshot, the fixed point, in one relax call."""
    img = _field(7)
    seeds = TransformBuilder.default().set_device("cpu").build_segmenting().find_local_minima(img) + [(0, 5)]
    want = getattr(TransformBuilder.default().set_device("cpu"), f"build_{variant}")().transform(img, seeds)
    ws = getattr(TransformBuilder.default().set_device("cpu").set_checkpoint(tmp_path, every=1), f"build_{variant}")()
    assert ws._ckpt_fast_path() and not ws._fast_observer_ok()
    _ext.reset_launches()
    np.testing.assert_array_equal(ws.transform(img, seeds), want)
    calls = _ext.launches["relax_plain"]
    assert [p.name.split("-")[0] for p in tmp_path.iterdir()] == ["planes"]
    _ext.reset_launches()
    dev = ws.transform(img, seeds, device_output=True)
    assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(), want)
    assert _ext.launches["relax_plain"] == 1 < calls


def _digest(ctx):
    return ctx.water_level, hashlib.sha1(ctx.colours.tobytes()).hexdigest()


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("variant", ["segmenting", "merging"])
def test_host_loop_interrupt_resume_matches_jax(tmp_path, variant, backend):
    """A hook that raises at level 40 interrupts the per-level loop; the
    resumed run starts after the level-32 snapshot and its hook results
    equal the JAX host loop's from level 33 on."""
    img = _field(8, (30, 36), hi=80)
    seeds = [(5, 5), (20, 30), (12, 12), (0, 9)]
    jb = getattr(JaxBuilder.default().set_max_water_lvl(80).set_wlvl_hook(_digest), f"build_{variant}")()
    want = jb.transform_with_hook(img, seeds)

    def boom(ctx):
        if ctx.water_level == 40:
            raise RuntimeError("interrupted at level 40")
        return _digest(ctx)

    def build(hook):
        tb = TransformBuilder.default().set_device("cpu").set_backend(backend).set_max_water_lvl(80)
        return getattr(tb.set_checkpoint(tmp_path, every=16).set_wlvl_hook(hook), f"build_{variant}")()

    with pytest.raises(RuntimeError, match="level 40"):
        build(boom).transform_with_hook(img, seeds)
    _ext.reset_launches()
    got = build(_digest).transform_with_hook(img, seeds)
    assert got == want[33:]
    assert (_ext.launches["flood_plain"] > 0) == (backend == "pallas")
    # A snapshot of the last level re-runs that level only.
    assert build(_digest).transform_with_hook(img, seeds) == want[-1:]
    np.testing.assert_array_equal(build(None).transform(img, seeds), np.asarray(jb.transform(img, seeds)))


def test_host_loop_random_tie_break_resumes(tmp_path):
    """Per-level snapshots under the random tie-break resume to the
    uninterrupted run's labels; another seed's snapshot is not resumed."""
    img = np.random.default_rng(9).integers(0, 12, size=(24, 28)).astype(np.uint8)
    seeds = TransformBuilder.default().set_device("cpu").build_segmenting().find_local_minima(img)

    def build(seed, hook=None):
        tb = TransformBuilder.default().set_device("cpu").set_max_water_lvl(11).set_tie_break("random", seed)
        return tb.set_checkpoint(tmp_path, every=4).set_wlvl_hook(hook).build_segmenting()

    want = {s: TransformBuilder.default().set_device("cpu").set_max_water_lvl(11).set_tie_break("random", s)
            .build_segmenting().transform(img, seeds) for s in (1, 2)}
    assert not np.array_equal(want[1], want[2])

    def boom(ctx):
        if ctx.water_level == 6:
            raise RuntimeError("interrupted")

    with pytest.raises(RuntimeError, match="interrupted"):
        build(1, boom).transform_with_hook(img, seeds)
    np.testing.assert_array_equal(build(2).transform(img, seeds), want[2])
    levels = build(1, lambda ctx: ctx.water_level).transform_with_hook(img, seeds)
    assert levels == list(range(5, 12))
    np.testing.assert_array_equal(build(1).transform(img, seeds), want[1])


def test_builder_from_jax_carries_the_options(tmp_path):
    jb = (JaxBuilder.default().set_max_water_lvl(90).set_tie_break("random", 5)
          .set_checkpoint(str(tmp_path), every=3))
    tb = builder_from_jax(jb, device="cpu")
    assert (tb.tie_break, tb.tie_break_seed, tb.checkpoint_dir, tb.checkpoint_every) == ("random", 5, str(tmp_path), 3)
    img = _field(10, (20, 22), hi=90)
    seeds = [(3, 3), (15, 17)]
    jn = JaxBuilder.default().set_backend("native").set_max_water_lvl(90)
    tn = builder_from_jax(jn, device="cpu")
    assert tn.backend == "native"
    np.testing.assert_array_equal(
        tn.build_merging().transform(img, seeds), np.asarray(jn.build_merging().transform(img, seeds))
    )
    jc = JaxBuilder.default().set_checkpoint(str(tmp_path / "c"), every=1)
    np.testing.assert_array_equal(
        builder_from_jax(jc, device="cpu").build_segmenting().transform(img, seeds),
        np.asarray(JaxBuilder.default().build_segmenting().transform(img, seeds)),
    )
    with pytest.raises(ValueError, match="a JAX Mesh"):  # a JAX mesh translates (test_torch_mesh_batch.py)
        builder_from_jax(JaxBuilder.default().set_mesh(object()), device="cpu")
