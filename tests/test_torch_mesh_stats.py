"""Per-level statistics on the port's mesh (parallel/tiled.py ``collect=``
and the builder's per-level API under ``set_mesh``) against the port's
single device and the JAX package's mesh on its virtual CPU devices.
Tolerance 0, on every rank.

One spawn of four gloo ranks (tests/torch_mesh.py) computes every case on
the meshes 1 x 1, 1 x 2, 2 x 1 and 2 x 2: ``tiled_transform`` with
``collect='sizes'``, ``'history'`` and ``'claims'`` (both variants; the
merging variant's statistics take the level sweep) on a divisible and the
non-divisible (37, 45) field, and the builder's ``transform_to_list``,
``transform_history`` and hook replay on the fields of
tests/test_parallel.py:430-545, the edge-corrected (31, 29) domain
included.  The fields hold no border seed, so the JAX mesh's one-way merge
(tests/test_torch_mesh_levels.py) does not show here.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rustronomy_watershed_tpu.ops import tune as j_tune
from rustronomy_watershed_tpu.parallel import tiled_transform as j_tiled
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
from torch_mesh import mesh_of, run_ranks

torch.set_num_threads(1)

MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]
VARIANTS = ["segmenting", "merging"]
MAXLVL = 11
FIELDS = {"24x40": (24, 40), "37x45": (37, 45)}
COLLECTS = [(v, c) for v in VARIANTS for c in ("sizes", "history")] + [("segmenting", "claims")]
# Builder fields (tests/test_parallel.py:430-545): shape, value range, water
# level, edge correction.
API = {"27x29": ((27, 29), 10, 9, False), "29x27 edge": ((29, 27), 10, 9, True)}


def _field(name):
    """``(img, seeds)``: random values below 12 and five interior seeds."""
    h, w = FIELDS[name]
    rng = np.random.default_rng(h * 100 + w)
    img = rng.integers(0, MAXLVL + 1, (h, w)).astype(np.uint8)
    seeds = sorted({(int(y), int(x)) for y, x in rng.integers(1, [h - 1, w - 1], size=(5, 2))})
    return img, seeds


def _api_field(name):
    (h, w), hi, _, _ = API[name]
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.integers(1, hi, (h, w)).astype(np.uint8)
    seeds = TransformBuilder().set_device("cpu").build_segmenting().find_local_minima(img)
    return img, [s for s in seeds if 0 < s[0] < h - 1 and 0 < s[1] < w - 1] or [(5, 5)]


def _api_builder(name, variant, mesh=None, jax_=False):
    _, _, maxlvl, edge = API[name]
    tb = JaxBuilder.default() if jax_ else TransformBuilder().set_device("cpu")
    tb.set_max_water_lvl(maxlvl)
    if edge:
        tb.enable_edge_correction()
    if mesh is not None:
        tb.set_mesh(mesh)
    return tb, variant


def _build(tb_variant):
    tb, variant = tb_variant
    return getattr(tb, f"build_{variant}")()


def _hook(ctx):
    return ctx.water_level, ctx.colours.copy(), ctx.seeds


def _rank_cases(rank):
    """Every case on this rank, for each mesh that holds it."""
    from rustronomy_watershed_tpu_torch.parallel import tiled_transform

    out = {}
    for shape in MESHES:
        mesh = mesh_of(shape)
        if mesh.get_coordinate() is None:
            continue
        for name in FIELDS:
            img, seeds = _field(name)
            lab0 = torch.from_numpy(paint_seeds(img.shape, seeds))
            for variant, collect in COLLECTS:
                res = tiled_transform(torch.from_numpy(img), lab0, mesh, n_labels=len(seeds), max_water_level=MAXLVL,
                                      merging=variant == "merging", collect=collect)
                out[("collect", shape, name, variant, collect)] = tuple(t.numpy() for t in res)
        for name in API:
            img, seeds = _api_field(name)
            for variant in VARIANTS:
                ws = _build(_api_builder(name, variant, mesh))
                out[("list", shape, name, variant)] = ws.transform_to_list(img, seeds, counts_length=len(seeds) + 1)
                out[("history", shape, name, variant)] = ws.transform_history(img, seeds)
                hooked = _build(_api_builder(name, variant, mesh))
                hooked.wlvl_hook = _hook
                out[("hook", shape, name, variant)] = hooked.transform_with_hook(img, seeds)
                out[("transform", shape, name, variant)] = ws.transform(img, seeds)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_rank_cases, 4, tmp_path_factory.mktemp("mesh_stats"))


@pytest.fixture(scope="module")
def small_jax_halo():
    """JAX's builder takes its mesh halo from ``ops.tune.relax_steps``; the
    labels do not depend on it (tests/test_parallel.py), but its jnp tiled
    engine unrolls k sweeps a round, whose compile takes about 45 s at the
    default k = 24 on these tiles and under a second at 2."""
    saved = j_tune.relax_steps
    j_tune.relax_steps = lambda *a, **k: 2
    yield
    j_tune.relax_steps = saved


def _jax_mesh(shape=(2, 2)):
    ny, nx = shape
    return Mesh(np.asarray(jax.devices()[: ny * nx]).reshape(ny, nx), ("y", "x"))


@functools.lru_cache(maxsize=None)
def _jax_collect(name, variant, collect):
    """JAX ``tiled_transform`` on its 2 x 2 mesh (JAX's tests hold its
    results equal on every mesh): the jnp engine for segmenting (claims on
    the Pallas engine in interpret mode), the level sweep for merging."""
    img, seeds = _field(name)
    kw = dict(n_labels=len(seeds), max_water_level=MAXLVL, merging=variant == "merging", collect=collect, halo=2)
    if collect == "claims":
        kw.update(backend="relax_pallas", halo=8)
    res = j_tiled(img, paint_seeds(img.shape, seeds), _jax_mesh(), **kw)
    return tuple(np.asarray(t) for t in res)


def _every_rank(ranks, shape, key):
    got = [ranks[r][key] for r in range(shape[0] * shape[1])]
    for g in got[1:]:
        _same(g, got[0], "the ranks disagree")
    return got[0]


def _same(got, want, msg=""):
    """Equal nested results: arrays (same dtype kind, tolerance 0), tuples,
    lists and plain values."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), msg
        for g, w in zip(got, want):
            _same(g, w, msg)
    elif isinstance(want, (np.ndarray, torch.Tensor)) or hasattr(want, "__array__"):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype.kind == want.dtype.kind, (msg, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        assert got == want, msg


@pytest.mark.parametrize("variant,collect", COLLECTS)
@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("shape", MESHES)
def test_collect_matches_single_device_and_jax(ranks, shape, name, variant, collect):
    """``tiled_transform(collect=...)`` on every rank == the port's
    single-device level driver (sizes, snapshots) or claim planes == JAX's
    tiled transform on its mesh; the padding of (37, 45) stays out of the
    uncoloured count."""
    img, seeds = _field(name)
    got = _every_rank(ranks, shape, ("collect", shape, name, variant, collect))
    merging = variant == "merging"
    if collect == "claims":
        want = run_levels_impl(img, paint_seeds(img.shape, seeds), max_water_level=MAXLVL, n_labels=len(seeds),
                               collect="history", backend="relax", device="cpu")
        labels, claim = got
        np.testing.assert_array_equal(labels, want[0].numpy())
        # The snapshots are the labels where the claim level is reached.
        lvls = np.arange(MAXLVL + 1)[:, None, None]
        np.testing.assert_array_equal(np.where(claim[None] <= lvls, labels[None], 0), want[1].numpy())
        assert (claim[0] == 256).all()  # border pixels are never claimed
    else:
        want = run_levels_impl(img, paint_seeds(img.shape, seeds), max_water_level=MAXLVL, merging=merging,
                               n_labels=len(seeds), collect=collect, backend="relax", device="cpu")
        _same(got, tuple(t.numpy() for t in want))
        if collect == "sizes":
            assert (got[1].sum(1) == img.size).all()
    _same(got, _jax_collect(name, variant, collect))


def _api_want(kind, name, variant, mesh=None):
    img, seeds = _api_field(name)
    ws = _build(_api_builder(name, variant, mesh, jax_=mesh is not None))
    if kind == "list":
        return ws.transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    if kind == "history":
        return ws.transform_history(img, seeds)
    if kind == "transform":
        return ws.transform(img, seeds)
    ws.wlvl_hook = _hook
    return ws.transform_with_hook(img, seeds)


@functools.lru_cache(maxsize=None)
def _jax_api(kind, name, variant):
    return _api_want(kind, name, variant, _jax_mesh())


@pytest.mark.parametrize("kind", ["list", "history", "hook", "transform"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(API))
@pytest.mark.parametrize("shape", MESHES)
def test_builder_per_level_api_on_a_mesh(ranks, small_jax_halo, shape, name, variant, kind):
    """``set_mesh`` builder: ``transform_to_list``, ``transform_history``,
    the hook replay and ``transform`` on every rank == the port's single
    device == JAX's mesh builder (tests/test_parallel.py:430-545)."""
    got = _every_rank(ranks, shape, (kind, shape, name, variant))
    _same(got, _api_want(kind, name, variant))
    _same(got, _jax_api(kind, name, variant))
    if kind in ("list", "history", "hook"):
        assert len(got) == API[name][2] + 1
