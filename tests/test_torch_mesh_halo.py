"""The port's halo exchange (parallel/halo.py) against the JAX package's, strip
for strip, on gloo meshes 1 x 1, 1 x 2, 2 x 1 and 2 x 2 of CPU processes
against shard_map on the virtual CPU devices; and ``make_mesh``.

One spawn of four gloo ranks (tests/torch_mesh.py) computes every case; the
tests compare its results with the JAX package's.  Integers, tolerance 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from rustronomy_watershed_tpu.parallel import halo as jhalo
from torch_mesh import mesh_of, run_ranks

MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]
H, W = 10, 12  # a rank's tile
EXCHANGES = [(1, "int32", 0), (3, "int32", 99), (4, "uint8", 255), (10, "int32", 7)]
REFRESH_K = [1, 4]
WP = 40  # the refresh's plane width: lane padding past w + 2k


def _tiles(ny, nx, dtype, seed=0):
    hi = 256 if dtype == "uint8" else 1 << 20
    return np.random.default_rng(seed + ny * 10 + nx).integers(0, hi, (ny * H, nx * W)).astype(dtype)


def _rank_cases(rank):
    """Every case on this rank, for each mesh that holds it: exchange_halo,
    refresh_halo_padded (plane and strips), global_interior_mask, and the
    shapes that make_mesh picks."""
    import torch

    from rustronomy_watershed_tpu_torch.parallel import exchange_halo, global_interior_mask, make_mesh
    from rustronomy_watershed_tpu_torch.parallel.halo import mesh_layout, refresh_halo_padded

    out = {}
    meshes = {shape: mesh_of(shape) for shape in MESHES}
    for shape, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        ny, nx, iy, ix = mesh_layout(mesh)
        block = (slice(iy * H, (iy + 1) * H), slice(ix * W, (ix + 1) * W))
        for k, dtype, fill in EXCHANGES:
            tile = torch.from_numpy(_tiles(ny, nx, dtype)[block].copy())
            out[("exchange", shape, k, dtype)] = exchange_halo(tile, k, mesh, off_grid_fill=fill).numpy()
        for k in REFRESH_K:
            tile = torch.from_numpy(_tiles(ny, nx, "int32", seed=1)[block].copy())
            plane = torch.full((H + 2 * k, WP), -7, dtype=torch.int32)
            plane[k : k + H, k : k + W] = tile
            plane, strips = refresh_halo_padded(plane, k, H, W, mesh, off_grid_fill=99, return_strips=True)
            out[("refresh", shape, k)] = (plane.numpy(), [s.numpy() for s in strips])
        for halo in (0, 1, 3):
            out[("interior", shape, halo)] = global_interior_mask((H, W), (ny * H - 1, nx * W - 2), halo, mesh).numpy()
    out["make_mesh"] = {n: tuple(make_mesh(n, device_type="cpu").mesh.shape) for n in (1, 2, 3, 4)}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_rank_cases, 4, tmp_path_factory.mktemp("halo"))


def _jax_mesh(shape):
    ny, nx = shape
    return Mesh(np.asarray(jax.devices()[: ny * nx]).reshape(ny, nx), ("y", "x"))


def _blocks(o, shape):
    """The devices' blocks of a shard_map output, in row-major rank order."""
    ny, nx = shape
    o = np.asarray(o)
    bh, bw = o.shape[0] // ny, o.shape[1] // nx
    return [o[iy * bh : (iy + 1) * bh, ix * bw : (ix + 1) * bw] for iy in range(ny) for ix in range(nx)]


@functools.lru_cache(maxsize=None)
def _jax_cases(shape):
    """Every case of ``_rank_cases`` on the JAX mesh of ``shape``, in one
    shard_map: ``{case: [block of each rank]}``."""
    ny, nx = shape
    names, inputs = [], []
    for k, dtype, fill in EXCHANGES:
        names.append(("exchange", k, dtype))
        inputs.append(_tiles(ny, nx, dtype))
    inputs.append(_tiles(ny, nx, "int32", seed=1))

    def local(*tiles):
        outs = [jhalo.exchange_halo(t, k, "y", "x", off_grid_fill=fill) for t, (k, _, fill) in zip(tiles, EXCHANGES)]
        for k in REFRESH_K:
            plane = jnp.full((H + 2 * k, WP), jnp.int32(-7))
            plane = jax.lax.dynamic_update_slice(plane, tiles[-1], (k, k))
            plane, strips = jhalo.refresh_halo_padded(plane, k, H, W, "y", "x", off_grid_fill=99, return_strips=True)
            outs += [plane, *strips]
        for halo in (0, 1, 3):
            outs.append(jhalo.global_interior_mask((H, W), (ny * H - 1, nx * W - 2), halo, "y", "x"))
        return tuple(outs)

    for k in REFRESH_K:
        names += [("refresh", k, i) for i in range(5)]
    names += [("interior", halo) for halo in (0, 1, 3)]
    outs = jax.jit(
        jax.shard_map(local, mesh=_jax_mesh(shape), in_specs=P("y", "x"), out_specs=P("y", "x"), check_vma=False)
    )(*map(jnp.asarray, inputs))
    return {name: _blocks(o, shape) for name, o in zip(names, outs)}


@pytest.mark.parametrize("k,dtype,fill", EXCHANGES)
@pytest.mark.parametrize("shape", MESHES)
def test_exchange_halo_matches_jax(ranks, shape, k, dtype, fill):
    """Rows first, then the columns of the row-extended tile (corners
    included), the off-grid fill at the mesh's edge; a halo as wide as the
    tile too."""
    want = _jax_cases(shape)[("exchange", k, dtype)]
    for r in range(shape[0] * shape[1]):
        got = ranks[r][("exchange", shape, k, dtype)]
        assert got.dtype == want[r].dtype
        np.testing.assert_array_equal(got, want[r], err_msg=f"rank {r}")


@pytest.mark.parametrize("k", REFRESH_K)
@pytest.mark.parametrize("shape", MESHES)
def test_refresh_halo_padded_matches_jax(ranks, shape, k):
    """The refreshed plane (junk in its halo band and lane padding before)
    and the four incoming strips, from the neighbours' centres only."""
    want = _jax_cases(shape)
    for r in range(shape[0] * shape[1]):
        got_plane, got_strips = ranks[r][("refresh", shape, k)]
        np.testing.assert_array_equal(got_plane, want[("refresh", k, 0)][r], err_msg=f"rank {r}")
        assert (got_plane[:, W + 2 * k :] == -7).all()  # the lane padding is left alone
        for i, s in enumerate(got_strips):
            np.testing.assert_array_equal(s, want[("refresh", k, i + 1)][r], err_msg=f"rank {r} strip {i}")


@pytest.mark.parametrize("halo", [0, 1, 3])
@pytest.mark.parametrize("shape", MESHES)
def test_global_interior_mask_matches_jax(ranks, shape, halo):
    """The global interior of a (ny * h - 1, nx * w - 2) image: the mesh
    padding lies outside it."""
    want = _jax_cases(shape)[("interior", halo)]
    for r in range(shape[0] * shape[1]):
        np.testing.assert_array_equal(ranks[r][("interior", shape, halo)], want[r], err_msg=f"rank {r}")


def test_make_mesh_is_near_square(ranks):
    """The JAX rule: ny the largest divisor of n at most sqrt(n)."""
    assert ranks[0]["make_mesh"] == {1: (1, 1), 2: (1, 2), 3: (1, 3), 4: (2, 2)}
    assert all(r["make_mesh"] == ranks[0]["make_mesh"] for r in ranks)
