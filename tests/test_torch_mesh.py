"""The port's mesh (parallel/tiled.py and ``set_mesh``) against the port's
single-device transform and the JAX package's ``tiled_transform`` (its
Pallas engine in interpret mode on the virtual CPU devices), on gloo meshes
1 x 1, 1 x 2, 2 x 1 and 2 x 2 of CPU processes.  Labels, tolerance 0, on
every rank.

One spawn of four gloo ranks (tests/torch_mesh.py) computes every case: the
public API (both variants, a non-divisible shape, edge correction), the
engine at halo widths 1, 3 and 8 and a lower water level, four randomised
trials, the round counts and the d-field saturation; the tests compare its
results.  The per-level statistics, the level loop and the batch axis have
their own files (tests/test_torch_mesh_stats.py, _levels.py, _batch.py).
"""

import functools
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rustronomy_watershed_tpu.parallel import tiled_transform as j_tiled
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
from torch_fields import corridor
from torch_mesh import mesh_of, one_rank_group, run_ranks

torch.set_num_threads(1)

MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]
FIELDS = {"64x96": ((64, 96), False), "37x45": ((37, 45), False), "37x45 edge": ((37, 45), True)}
VARIANTS = ["segmenting", "merging"]
# (field, halo, max_water_level) of the engine's cases.
HALOS = [(f, k, 254) for f in ("64x96", "37x45") for k in (1, 3, 8)] + [("64x96", 3, 30)]
# Randomised trials where the JAX mesh's merge differs from every
# single-device transform (a label held only by a border seed stays
# unmerged there; see parallel/tiled.py::_merge_fixed_point).
JAX_MESH_MERGE_FAULT = {2}


def _field(name):
    """``(img, seeds)``: a random 0..39 field with 10% NEVER_FILL dots and
    seven seeds, one of them on the border."""
    (h, w), _ = FIELDS[name]
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.integers(0, 40, (h, w)).astype(np.uint8)
    img[rng.random((h, w)) < 0.1] = 255
    pts = {(int(y), int(x)) for y, x in rng.integers(1, [h - 1, w - 1], size=(6, 2))}
    return img, sorted(pts) + [(0, w // 3)]


def _trial(i):
    """``(mesh, img, seeds, max_water_level, merging)`` of randomised trial
    ``i`` (tests/test_parallel.py:309-336, on the port's meshes)."""
    rng = np.random.default_rng(7000 + i)
    ny, nx = MESHES[i]
    h = int(rng.integers(2, 4)) * 8 * ny
    w = nx * max(8, int(rng.integers(1, 3)) * 16)
    hi = int(rng.choice([4, 16, 254]))
    maxlvl = int(rng.choice([2, hi // 2 + 1, 254]))
    merging = bool(rng.integers(0, 2))
    img = rng.integers(0, hi, size=(h, w)).astype(np.uint8)
    img[rng.random((h, w)) < 0.02] = 0
    img[rng.random((h, w)) < 0.02] = 255
    n_seeds = int(rng.integers(2, 7))
    seeds = sorted({(int(rng.integers(0, h)), int(rng.integers(0, w))) for _ in range(n_seeds)})
    return MESHES[i], img, seeds, maxlvl, merging


ROUNDS_IMG = np.random.default_rng(11).integers(0, 254, (128, 128)).astype(np.uint8)


def _rank_cases(rank):
    """Every case on this rank, for each mesh that holds it."""
    from rustronomy_watershed_tpu_torch.ops import relax
    from rustronomy_watershed_tpu_torch.parallel import tiled_transform

    out = {}
    meshes = {shape: mesh_of(shape) for shape in MESHES}
    for shape, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        for name, (_, edge) in FIELDS.items():
            img, seeds = _field(name)
            for variant in VARIANTS:
                tb = TransformBuilder().set_device("cpu").set_mesh(mesh)
                if edge:
                    tb.enable_edge_correction()
                out[("api", shape, name, variant)] = getattr(tb, f"build_{variant}")().transform(img, seeds)
                if edge:
                    continue
                lab0 = torch.from_numpy(paint_seeds(img.shape, seeds))
                for _, halo, maxlvl in (c for c in HALOS if c[0] == name):
                    out[("halo", shape, name, variant, halo, maxlvl)] = tiled_transform(
                        torch.from_numpy(img), lab0, mesh, n_labels=len(seeds), max_water_level=maxlvl,
                        merging=variant == "merging", halo=halo,
                    ).numpy()
        seeds = TransformBuilder().set_device("cpu").build_segmenting().find_local_minima(ROUNDS_IMG)
        labels, stats = tiled_transform(
            torch.from_numpy(ROUNDS_IMG), torch.from_numpy(paint_seeds(ROUNDS_IMG.shape, seeds)), mesh,
            n_labels=len(seeds), max_water_level=254, with_stats=True,
        )
        out[("rounds", shape)] = (labels.numpy(), stats)
        # The d field narrowed to 7 bits: the corridor saturates it.
        saved = relax._D_BITS
        relax._D_BITS = 7
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = TransformBuilder().set_device("cpu").set_mesh(mesh).build_segmenting().transform(corridor(), [(1, 1)])
        finally:
            relax._D_BITS = saved
        out[("saturation", shape)] = (got, [str(c.message) for c in caught])
    for i in range(4):
        shape, img, seeds, maxlvl, merging = _trial(i)
        if meshes[shape].get_coordinate() is not None:
            tb = TransformBuilder().set_device("cpu").set_max_water_lvl(maxlvl).set_mesh(meshes[shape])
            out[("trial", i)] = getattr(tb, "build_merging" if merging else "build_segmenting")().transform(img, seeds)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_rank_cases, 4, tmp_path_factory.mktemp("mesh"))


def _builder(variant, maxlvl=254, edge=False):
    tb = TransformBuilder().set_device("cpu").set_max_water_lvl(maxlvl)
    if edge:
        tb.enable_edge_correction()
    return getattr(tb, f"build_{variant}")()


@functools.lru_cache(maxsize=None)
def _jax_labels(key, variant, maxlvl=254):
    """JAX ``tiled_transform`` (the Pallas engine, interpret mode) on the
    JAX mesh (2 x 2 for a field, the trial's own for a trial: JAX's tests
    hold its labels equal on every mesh), from the JAX builder's own
    preparation of the field ``key`` (a FIELDS name or a trial index)."""
    if isinstance(key, int):
        shape, img, seeds, maxlvl, merging = _trial(key)
        edge = False
    else:
        img, seeds = _field(key)
        shape, edge, merging = (2, 2), FIELDS[key][1], variant == "merging"
    jb = JaxBuilder.default()
    if edge:
        jb.enable_edge_correction()
    jimg, lab0 = jb.build_segmenting()._prepare(img, seeds)
    ny, nx = shape
    mesh = Mesh(np.asarray(jax.devices()[: ny * nx]).reshape(ny, nx), ("y", "x"))
    return np.asarray(j_tiled(jimg, lab0, mesh, n_labels=len(seeds), max_water_level=maxlvl, merging=merging,
                              halo=8, backend="relax_pallas"))


def _every_rank(ranks, shape, key):
    got = [ranks[r][key] for r in range(shape[0] * shape[1])]
    assert all(g.dtype == np.int32 and np.array_equal(g, got[0]) for g in got), "the ranks disagree"
    return got[0]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_api_matches_single_device_and_jax(ranks, shape, name, variant):
    """``set_mesh(mesh).build_<variant>().transform(img, seeds)`` on every
    rank == the single-device transform == JAX's tiled transform on the
    same mesh shape (non-divisible shapes pad inertly; edge correction)."""
    img, seeds = _field(name)
    got = _every_rank(ranks, shape, ("api", shape, name, variant))
    np.testing.assert_array_equal(got, _builder(variant, edge=FIELDS[name][1]).transform(img, seeds))
    np.testing.assert_array_equal(got, _jax_labels(name, variant))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name,halo,maxlvl", HALOS)
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_engine_at_each_halo_width(ranks, shape, name, halo, maxlvl, variant):
    """``tiled_transform`` with halos of 1, 3 and 8 (a round of k sweeps
    each) and at water level 30: the labels do not depend on the halo."""
    img, seeds = _field(name)
    got = _every_rank(ranks, shape, ("halo", shape, name, variant, halo, maxlvl))
    want = run_levels_impl(img, paint_seeds(img.shape, seeds), max_water_level=maxlvl, merging=variant == "merging",
                           n_labels=len(seeds), backend="packed", device="cpu")
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, _jax_labels(name, variant, maxlvl))


@pytest.mark.parametrize("trial", range(4))
def test_mesh_randomised(ranks, trial):
    """Random shapes, value ranges, water levels and seeds (on the border
    too), trial i on mesh i.  Where the JAX mesh's merge keeps a border
    seed's label unmerged (trial 2), the port's labels are the JAX
    single-device transform's, and the JAX mesh's differ from both."""
    shape, img, seeds, maxlvl, merging = _trial(trial)
    got = _every_rank(ranks, shape, ("trial", trial))
    variant = "merging" if merging else "segmenting"
    np.testing.assert_array_equal(got, _builder(variant, maxlvl).transform(img, seeds), err_msg=f"trial {trial}")
    want = _jax_labels(trial, variant)
    if trial in JAX_MESH_MERGE_FAULT:
        jb = JaxBuilder.default().set_max_water_lvl(maxlvl)
        single = np.asarray(getattr(jb, f"build_{variant}")().transform(img, seeds))
        assert merging and not np.array_equal(want, single)
        bad = np.argwhere(want != single)
        assert all(y in (0, img.shape[0] - 1) or x in (0, img.shape[1] - 1) for y, x in bad)  # border pixels only
        want = single
    np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_mesh_rounds_at_most_one_more_than_one_by_one(ranks):
    """The round invariant (tiled.py:739-743, tests/test_parallel.py:743):
    with the default halo, a mesh takes at most one round more than 1 x 1,
    whose protocol is the witness alone; every rank runs at most one call a
    round, and the first round runs them all."""
    stats = {}
    for shape in MESHES:
        labels, stats[shape] = ranks[0][("rounds", shape)]
        assert all(ranks[r][("rounds", shape)][1] == stats[shape] for r in range(shape[0] * shape[1]))
        np.testing.assert_array_equal(labels, ranks[0][("rounds", (1, 1))][0])
    r11 = stats[(1, 1)][0]
    assert stats[(1, 1)][1] == r11
    for (ny, nx), (rounds, runs) in stats.items():
        assert r11 <= rounds <= r11 + 1, ((ny, nx), rounds, r11)
        assert ny * nx <= runs <= ny * nx * rounds


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_saturation_warns_and_reruns_exactly(ranks, shape):
    """A deliberate divergence from the JAX mesh, which drops the kernel's
    saturation bit: the port reduces it over the mesh, and every rank warns
    and re-runs on the exact engine."""
    got, messages = ranks[0][("saturation", shape)]
    for r in range(shape[0] * shape[1]):
        np.testing.assert_array_equal(ranks[r][("saturation", shape)][0], got)
        assert any("saturation" in m for m in ranks[r][("saturation", shape)][1]), f"rank {r} did not warn"
    exact = TransformBuilder().set_device("cpu").set_backend("relax").build_segmenting().transform(corridor(), [(1, 1)])
    np.testing.assert_array_equal(got, exact)
    assert (got[corridor() == 5] == 1).all()


def test_mesh_refuses_what_item_13b_brings(tmp_path):
    """What ROADMAP item 13 (b) brought is served, and what a mesh still
    refuses raises.  Under set_mesh on a one-rank mesh: the host-stepped
    loop's options and checkpoints build and their runs equal the single
    device's; the per-level entries and ``collect='sizes'`` serve; a
    ``'batch'`` dim builds; transform_batch without a 'batch' dim and
    transform_with_hook without a hook serve; the random tie-break, a 1-D
    mesh and a mesh that is not one raise ValueError; a CUDA builder on a
    host without CUDA still raises; builder_from_jax translates a JAX mesh;
    JAX's jnp tiled engine (``backend='relax'``, item 13 (c)) serves and
    equals the single device."""
    from torch.distributed.device_mesh import DeviceMesh

    from rustronomy_watershed_tpu_torch.convert import builder_from_jax
    from rustronomy_watershed_tpu_torch.parallel import tiled_transform
    from rustronomy_watershed_tpu_torch.parallel.tiled import _relax_collect_tail

    img, seeds = _field("37x45")
    single = _builder("merging")
    (tmp_path / "plots").mkdir()
    with one_rank_group(tmp_path) as mesh:
        def tb():
            return TransformBuilder().set_device("cpu").set_mesh(mesh)

        hook = lambda ctx: ctx.colours.copy()  # noqa: E731
        for configure in (
            lambda b: b.set_wlvl_hook(hook), lambda b: b.set_plot_folder(str(tmp_path / "plots")),
            lambda b: b.enable_progress(), lambda b: b.enable_debug(), lambda b: b.set_checkpoint(str(tmp_path / "c")),
        ):
            np.testing.assert_array_equal(configure(tb()).build_merging().transform(img, seeds),
                                          single.transform(img, seeds))
        batch = DeviceMesh("cpu", [[[0]]], mesh_dim_names=("batch", "y", "x"))
        np.testing.assert_array_equal(TransformBuilder().set_device("cpu").set_mesh(batch).build_merging()
                                      .transform_batch(img[None], [seeds]), single.transform_batch(img[None], [seeds]))
        ws = tb().build_merging()
        for entry in ("transform_to_list", "transform_history"):
            got, want = getattr(ws, entry)(img, seeds), getattr(single, entry)(img, seeds)
            assert len(got) == len(want) and all(g[0] == w[0] and np.array_equal(g[1], w[1]) for g, w in zip(got, want))
        lab = torch.zeros((4, 4), dtype=torch.int32)
        sizes = _relax_collect_tail(lab, torch.full((4, 4), 256), global_shape=(4, 4), n_labels=1,
                                    max_water_level=2, merging=False, collect="sizes", mesh=mesh)[1]
        np.testing.assert_array_equal(sizes.numpy(), [[16, 0]] * 3)
        np.testing.assert_array_equal(
            tiled_transform(torch.from_numpy(img), torch.from_numpy(paint_seeds(img.shape, seeds)), mesh,
                            n_labels=len(seeds), max_water_level=254, merging=True, backend="relax").numpy(),
            single.transform(img, seeds))
        assert ws.transform_with_hook(img, seeds) == []
        np.testing.assert_array_equal(ws.transform_batch(img[None], [seeds]), single.transform_batch(img[None], [seeds]))
        np.testing.assert_array_equal(ws.transform(img, seeds), single.transform(img, seeds))
        with pytest.raises(ValueError, match="single-device"):
            tb().set_tie_break("random").build_segmenting()
        for bad in (DeviceMesh("cpu", [0], mesh_dim_names=("y",)), object()):
            with pytest.raises(ValueError, match="'y', 'x'"):
                TransformBuilder().set_device("cpu").set_mesh(bad).build_segmenting()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                TransformBuilder().set_mesh(mesh).build_segmenting().transform(img, seeds)
        jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("y", "x"))
        translated = builder_from_jax(JaxBuilder.default().set_mesh(jmesh), device="cpu")
        assert translated.mesh.mesh_dim_names == ("y", "x")
        np.testing.assert_array_equal(translated.build_merging().transform(img, seeds), single.transform(img, seeds))
