"""JAX's jnp tiled relax engine on the port's mesh
(``tiled_transform(backend='relax')``, parallel/tiled.py
``_local_relax_driver``) against the port's single device and the JAX
package's ``tiled_transform(backend='relax')`` on its virtual CPU devices,
at the same halo.  Tolerance 0, on every rank.

One spawn of gloo ranks (tests/torch_mesh.py) per mesh: 1 x 1, 1 x 2,
2 x 1, 2 x 2 and the ``("batch", "y", "x")`` = (2, 1, 2) batch mesh.  Each
computes ``collect`` 'none' (both variants), 'sizes', 'history' and
'claims' on a divisible field, the non-divisible (37, 45) field and the
edge-corrected (31, 29) domain, at water levels 11 and 5; the claim levels
against the packed engine's; and the border-seed trial of
tests/test_torch_mesh.py, where the JAX mesh's one-way merge keeps a border
seed's label apart (ROADMAP queue 3) and the port's does not.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rustronomy_watershed_tpu.parallel import tiled_transform as j_tiled
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.ops.priority import relax_transform
from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
from test_torch_mesh import JAX_MESH_MERGE_FAULT, _trial
from torch_mesh import mesh_of, run_ranks

torch.set_num_threads(1)

MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]
BATCH_MESH = (2, 1, 2)
HALO = 2
FIELDS = ["24x40", "37x45", "31x29 edge"]
# (variant, collect): the collects JAX's relax engine serves.
CASES = [("segmenting", "none"), ("merging", "none"), ("segmenting", "sizes"), ("segmenting", "history"),
         ("segmenting", "claims")]
LEVELS = [11, 5]
(BORDER_TRIAL,) = JAX_MESH_MERGE_FAULT


def _field(name):
    """``(domain, painted seeds, n_labels)``: random values below 12 and
    five interior seeds; the edge-corrected field is its (33, 31) domain
    (a zero ring, seeds painted without the shift, as ``_prepare``)."""
    h, w = (int(n) for n in name.split()[0].split("x"))
    rng = np.random.default_rng(h * 100 + w)
    img = rng.integers(0, 12, (h, w)).astype(np.uint8)
    seeds = sorted({(int(y), int(x)) for y, x in rng.integers(1, [h - 1, w - 1], size=(5, 2))})
    if name.endswith("edge"):
        img = np.pad(img, 1, constant_values=0)
    return img, paint_seeds(img.shape, seeds), len(seeds)


def _stack():
    """Four images of (20, 26) with four seeds each, for the batch mesh."""
    rng = np.random.default_rng(77)
    imgs = rng.integers(0, 12, (4, 20, 26)).astype(np.uint8)
    lab0 = np.stack([paint_seeds((20, 26), sorted({(int(y), int(x)) for y, x in rng.integers(1, [19, 25], (4, 2))}))
                     for _ in range(4)])
    return imgs, lab0, int(lab0.max())


def _run(fn, img, lab0, n, variant, collect, lvl, **kw):
    out = fn(img, lab0, n_labels=n, max_water_level=lvl, merging=variant == "merging", collect=collect, **kw)
    return tuple(np.asarray(t) for t in (out if collect != "none" else (out,)))


def _spatial_cases(shape):
    """One rank's results on the ``shape`` mesh (a spawned process)."""
    from rustronomy_watershed_tpu_torch.parallel import tiled_transform

    mesh = mesh_of(shape)
    out = {}
    for name in FIELDS:
        img, lab0, n = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in _field(name))
        for variant, collect in CASES:
            for lvl in LEVELS:
                out[(name, variant, collect, lvl)] = _run(
                    lambda *a, **k: tiled_transform(*a, mesh, backend="relax", halo=HALO, **k),
                    img, lab0, n, variant, collect, lvl)
        out[(name, "packed claims")] = _run(lambda *a, **k: tiled_transform(*a, mesh, backend="packed", **k),
                                            img, lab0, n, "segmenting", "claims", 254)
        for variant in ("segmenting", "merging"):  # the default halo
            out[(name, variant, "default halo")] = _run(lambda *a, **k: tiled_transform(*a, mesh, backend="relax", **k),
                                                        img, lab0, n, variant, "none", 254)
    trial_shape, img, seeds, maxlvl, merging = _trial(BORDER_TRIAL)
    if trial_shape == tuple(shape):
        out["border trial"] = tiled_transform(torch.from_numpy(img), torch.from_numpy(paint_seeds(img.shape, seeds)),
                                              mesh, n_labels=len(seeds), max_water_level=maxlvl, merging=merging,
                                              backend="relax", halo=HALO).numpy()
    return out


def _batch_cases():
    from torch.distributed.device_mesh import DeviceMesh

    from rustronomy_watershed_tpu_torch.parallel import tiled_transform

    mesh = DeviceMesh("cpu", torch.arange(4).reshape(BATCH_MESH), mesh_dim_names=("batch", "y", "x"))
    imgs, lab0, n = _stack()
    return {(variant, collect): _run(lambda *a, **k: tiled_transform(*a, mesh, backend="relax", halo=HALO,
                                                                     axis_batch="batch", **k),
                                     torch.from_numpy(imgs), torch.from_numpy(lab0), n, variant, collect, 11)
            for variant, collect in CASES}


def _rank_main(rank, shape):
    return _batch_cases() if len(shape) == 3 else _spatial_cases(shape)


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: "x".join(map(str, s)))
def spatial(request, tmp_path_factory):
    """``(mesh shape, every rank's results)``: one spawn of ny * nx ranks."""
    shape = request.param
    return shape, run_ranks(_rank_main, shape[0] * shape[1], tmp_path_factory.mktemp("mesh_relax"), shape)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    return run_ranks(_rank_main, int(np.prod(BATCH_MESH)), tmp_path_factory.mktemp("mesh_relax_batch"), BATCH_MESH)


def _every_rank(results, key):
    got = [r[key] for r in results]
    for g in got[1:]:
        _same(g, got[0])
    return got[0]


def _jax_mesh(shape):
    names = ("batch", "y", "x") if len(shape) == 3 else ("y", "x")
    return Mesh(np.asarray(jax.devices()[: int(np.prod(shape))]).reshape(shape), names)


@functools.lru_cache(maxsize=None)
def _jax(name, variant, collect, lvl):
    """JAX's jnp tiled engine at the same halo on its 2 x 2 mesh (its tests
    hold the results equal on every mesh)."""
    img, lab0, n = _field(name)
    return _run(lambda *a, **k: j_tiled(*a, _jax_mesh((2, 2)), backend="relax", halo=HALO, **k),
                img, lab0, n, variant, collect, lvl)


def _single(img, lab0, n, variant, collect, lvl):
    """The port's single device: the exact engine (with the merge for
    merging), the claims as ``relax_transform`` gives them."""
    if collect == "claims":
        labels, claim = relax_transform(torch.from_numpy(img), torch.from_numpy(lab0), max_water_level=lvl)
        return labels.numpy(), claim.numpy()
    out = run_levels_impl(img, lab0, n_labels=n, max_water_level=lvl, merging=variant == "merging",
                          collect=collect, backend="relax", device="cpu")
    return tuple(t.numpy() for t in (out if collect != "none" else (out,)))


def _same(got, want):
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype.kind == w.dtype.kind, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lvl", LEVELS)
@pytest.mark.parametrize("variant,collect", CASES)
@pytest.mark.parametrize("name", FIELDS)
def test_relax_engine_matches_single_device_and_jax(spatial, name, variant, collect, lvl):
    """Every collect on every rank == the port's single device == JAX's
    jnp tiled engine at halo 2 (sizes against the original domain; the
    claim levels as the unpacked engine gives them)."""
    _, results = spatial
    got = _every_rank(results, (name, variant, collect, lvl))
    img, lab0, n = _field(name)
    _same(got, _single(img, lab0, n, variant, collect, lvl))
    _same(got, _jax(name, variant, collect, lvl))


@pytest.mark.parametrize("name", FIELDS)
def test_claim_levels_equal_the_packed_engines(spatial, name):
    """The unpacked claim levels L == the packed engine's ``key >> d_bits``
    (256 where unclaimed) below level 255; the packed key leaves level 255
    unclaimed (it is the unclaimed key's level), where the unpacked engine
    claims NEVER_FILL cells, the border ring among them, at 255."""
    _, results = spatial
    _, claim = _every_rank(results, (name, "segmenting", "claims", 11))
    _, packed = _every_rank(results, (name, "packed claims"))
    np.testing.assert_array_equal(np.where(claim >= 255, 256, claim), packed)
    assert (claim[0] == 255).all() and (packed[0] == 256).all()


@pytest.mark.parametrize("variant", ["segmenting", "merging"])
@pytest.mark.parametrize("name", FIELDS)
def test_default_halo(spatial, name, variant):
    """``halo=None``: ``DEFAULT_STEPS`` clamped to the tile; the labels do
    not depend on it."""
    _, results = spatial
    img, lab0, n = _field(name)
    _same(_every_rank(results, (name, variant, "default halo")), _single(img, lab0, n, variant, "none", 254))


def test_border_seed_merges_as_on_one_device(spatial):
    """tests/test_torch_mesh.py's border-seed trial on its own mesh: the
    port's jnp engine merges the border seed's label as every single-device
    transform does; JAX's tiled jnp engine keeps it apart (its one-way mesh
    merge, ROADMAP queue 3), on border pixels only."""
    shape, results = spatial
    trial_shape, img, seeds, maxlvl, merging = _trial(BORDER_TRIAL)
    if trial_shape != shape:
        assert all("border trial" not in r for r in results)
        return
    got = _every_rank(results, "border trial")
    variant = "merging" if merging else "segmenting"
    single = np.asarray(getattr(JaxBuilder.default().set_max_water_lvl(maxlvl), f"build_{variant}")().transform(img, seeds))
    np.testing.assert_array_equal(got, single)
    np.testing.assert_array_equal(got, getattr(TransformBuilder().set_device("cpu").set_max_water_lvl(maxlvl),
                                               f"build_{variant}")().transform(img, seeds))
    jmesh = j_tiled(img, paint_seeds(img.shape, seeds), _jax_mesh(trial_shape), n_labels=len(seeds),
                    max_water_level=maxlvl, merging=merging, backend="relax", halo=HALO)
    bad = np.argwhere(np.asarray(jmesh) != single)
    assert merging and len(bad) and all(y in (0, img.shape[0] - 1) or x in (0, img.shape[1] - 1) for y, x in bad)


@pytest.mark.parametrize("variant,collect", CASES)
def test_batch_mesh(batch, variant, collect):
    """The (2, 1, 2) batch mesh: every rank == JAX's batch mesh on the jnp
    engine == the port's single device image by image (the statistics
    stacked on their batch axis)."""
    got = _every_rank(batch, (variant, collect))
    imgs, lab0, n = _stack()
    _same(got, _run(lambda *a, **k: j_tiled(*a, _jax_mesh(BATCH_MESH), backend="relax", halo=HALO,
                                            axis_batch="batch", **k), imgs, lab0, n, variant, collect, 11))
    per = [_single(imgs[i], lab0[i], n, variant, collect, 11) for i in range(len(imgs))]
    axes = {"sizes": 1, "history": 1}
    _same(got, tuple(np.stack([p[j] for p in per], axis=0 if j == 0 else axes.get(collect, 0))
                     for j in range(len(per[0]))))
