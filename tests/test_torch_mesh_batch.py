"""The batch axis of the port's mesh (``tiled_transform(axis_batch=)`` and
``transform_batch`` under a ``("batch", "y", "x")`` mesh) and
``convert.builder_from_jax`` with a JAX mesh, against the port's single
device and the JAX package's batch mesh on its virtual CPU devices.
Tolerance 0, on every rank.

One spawn of four gloo ranks (tests/torch_mesh.py) on the batch mesh
(2, 1, 2): two batch groups, each a 1 x 2 spatial mesh.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rustronomy_watershed_tpu.parallel import tiled_transform as j_tiled
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
from torch_mesh import one_rank_group, run_ranks

torch.set_num_threads(1)

BATCH_MESH = (2, 1, 2)
VARIANTS = ["segmenting", "merging"]
MAXLVL = 11
SHAPE = (24, 30)
STACKS = {"B=4": 4, "B=2": 2}


def _stack(b, seed=0):
    """``(imgs, seeds_list)``: ``b`` random images, four interior seeds each."""
    rng = np.random.default_rng(100 + b + seed)
    h, w = SHAPE
    imgs = rng.integers(0, MAXLVL + 1, (b, h, w)).astype(np.uint8)
    seeds = [sorted({(int(y), int(x)) for y, x in rng.integers(1, [h - 1, w - 1], size=(4, 2))}) for _ in range(b)]
    return imgs, seeds


def _painted(imgs, seeds_list):
    return np.stack([paint_seeds(imgs.shape[1:], s) for s in seeds_list])


def _batch_mesh():
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(4).reshape(BATCH_MESH), mesh_dim_names=("batch", "y", "x"))


def _builder(variant, mesh=None, edge=False):
    tb = TransformBuilder().set_device("cpu").set_max_water_lvl(MAXLVL)
    if edge:
        tb.enable_edge_correction()
    if mesh is not None:
        tb.set_mesh(mesh)
    return getattr(tb, f"build_{variant}")()


def _rank_cases(rank):
    from rustronomy_watershed_tpu_torch.parallel import tiled_transform

    mesh = _batch_mesh()
    out = {}
    for stack, b in STACKS.items():
        imgs, seeds = _stack(b)
        for variant in VARIANTS:
            for edge in (False, True):
                out[("batch", stack, variant, edge)] = _builder(variant, mesh, edge).transform_batch(imgs, seeds)
            n = max(len(s) for s in seeds)
            for collect in ("none", "sizes"):
                res = tiled_transform(torch.from_numpy(imgs), torch.from_numpy(_painted(imgs, seeds)), mesh,
                                      n_labels=n, max_water_level=MAXLVL, merging=variant == "merging",
                                      collect=collect, axis_batch="batch")
                out[("tiled", stack, variant, collect)] = tuple(t.numpy() for t in (res if collect != "none" else (res,)))
    imgs, seeds = _stack(3)
    try:
        _builder("merging", mesh).transform_batch(imgs, seeds)
        out["B=3"] = None
    except ValueError as e:
        out["B=3"] = str(e)
    img, seeds = _stack(1)
    out["transform"] = _builder("merging", mesh).transform(img[0], seeds[0])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_rank_cases, 4, tmp_path_factory.mktemp("mesh_batch"))


def _every_rank(ranks, key):
    got = [r[key] for r in ranks]
    for g in got[1:]:
        for a, b in zip(g if isinstance(g, tuple) else (g,), got[0] if isinstance(got[0], tuple) else (got[0],)):
            np.testing.assert_array_equal(a, b, err_msg="the ranks disagree")
    return got[0]


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("stack", list(STACKS))
def test_transform_batch_on_the_batch_mesh(ranks, stack, variant, edge):
    """``transform_batch`` on the (2, 1, 2) mesh on every rank == each
    image's single-device transform == the single device's
    ``transform_batch``."""
    imgs, seeds = _stack(STACKS[stack])
    got = _every_rank(ranks, ("batch", stack, variant, edge))
    single = _builder(variant, edge=edge)
    assert got.shape[0] == imgs.shape[0] and got.dtype == np.int32
    for i in range(imgs.shape[0]):
        np.testing.assert_array_equal(got[i], single.transform(imgs[i], seeds[i]), err_msg=f"image {i}")
    np.testing.assert_array_equal(got, single.transform_batch(imgs, seeds))


@functools.lru_cache(maxsize=None)
def _jax_batch(stack, variant, collect):
    """JAX ``tiled_transform`` with ``axis_batch`` on its (2, 1, 2) mesh
    (its jnp engine for segmenting, the level sweep for merging sizes)."""
    imgs, seeds = _stack(STACKS[stack])
    devs = np.asarray(jax.devices()[:4]).reshape(BATCH_MESH)
    res = j_tiled(imgs, _painted(imgs, seeds), Mesh(devs, ("batch", "y", "x")), n_labels=max(len(s) for s in seeds),
                  max_water_level=MAXLVL, merging=variant == "merging", collect=collect, axis_batch="batch", halo=2)
    return tuple(np.asarray(t) for t in (res if collect != "none" else (res,)))


@pytest.mark.parametrize("collect", ["none", "sizes"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("stack", list(STACKS))
def test_tiled_transform_batch_axis_matches_jax(ranks, stack, variant, collect):
    """``tiled_transform(axis_batch='batch')``: the ``(B, H, W)`` labels and
    the ``(levels, B, K+1)`` sizes on every rank == JAX's batch mesh."""
    got = _every_rank(ranks, ("tiled", stack, variant, collect))
    want = _jax_batch(stack, variant, collect)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_batch_not_divisible_raises_and_transform_serves(ranks):
    """A batch of 3 on 2 batch groups raises ValueError on every rank (as
    JAX's shard_map requires B divisible); ``transform`` on the batch mesh
    (no batch axis) == the single device's."""
    for r in ranks:
        assert r["B=3"] is not None and "divisible by the 2 batch groups" in r["B=3"]
    img, seeds = _stack(1)
    got = _every_rank(ranks, "transform")
    np.testing.assert_array_equal(got, _builder("merging").transform(img[0], seeds[0]))


def test_builder_from_jax_translates_a_jax_mesh(tmp_path):
    """``builder_from_jax`` with a JAX 1 x 1 mesh: a ``("y", "x")``
    DeviceMesh of shape (1, 1) over the one-rank world, whose transform ==
    the single device's; a JAX mesh of another size than the world's, or no
    process group, raise ValueError naming both sizes."""
    from rustronomy_watershed_tpu_torch.convert import builder_from_jax

    img, seeds = _stack(1)
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("y", "x"))
    big = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("y", "x"))
    with pytest.raises(ValueError, match="4 devices, but no process group is initialised"):
        builder_from_jax(JaxBuilder.default().set_mesh(big), device="cpu")
    with one_rank_group(tmp_path):
        tb = builder_from_jax(JaxBuilder.default().set_max_water_lvl(MAXLVL).set_mesh(jmesh), device="cpu")
        assert tb.mesh.mesh_dim_names == ("y", "x") and tuple(tb.mesh.mesh.shape) == (1, 1)
        assert tb.mesh.device_type == "cpu"
        np.testing.assert_array_equal(tb.build_merging().transform(img[0], seeds[0]),
                                      _builder("merging").transform(img[0], seeds[0]))
        with pytest.raises(ValueError, match=r"has 4 devices, but the world has 1 ranks"):
            builder_from_jax(JaxBuilder.default().set_mesh(big), device="cpu")
