#!/usr/bin/env python3
"""Dry run of the port's mesh on 8, 16 and 32 gloo ranks on the CPU.

    python3 tools/torch_mesh_dryrun.py [--sizes 8 16 32]

The counterpart of ``__graft_entry__.py::dryrun_multichip`` for the PyTorch
package: each size spawns that many gloo processes
(``tests/torch_mesh.py::run_ranks``, one thread each) that run, SPMD:

* a ``("batch", "y", "x")`` mesh of (n / 4, 2, 2), where n divides by 4:
  ``tiled_transform(axis_batch='batch')`` of two images a batch group,
  merging with ``collect='sizes'`` (the level sweep on the flood kernel's
  twin) and segmenting with ``collect='history'`` (the packed engine and
  JAX's jnp engine ``backend='relax'``);
* the spatial mesh (the most-square power-of-two ``ny x nx``, as the JAX
  dry run takes): the non-divisible (37, 45) field, both variants, on the
  packed and the ``'relax'`` engine;
  ``MeshLevelStepper`` stepped by hand against the whole transform; the
  round invariant, at most one exchange round over 1 x 1 (``with_stats``
  on a 256^2 field); and through the builder, with edge correction, the
  transform, ``transform_to_list`` and ``transform_history``.

The parent holds every rank's results against the single-device port at
tolerance 0 and prints one OK line per size; any difference, or a rank that
fails or misses its deadline, exits non-zero.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from torch_mesh import run_ranks  # noqa: E402

SHAPE, BATCH_LVL = (32, 32), 8
ND_SHAPE, ND_LVL = (37, 45), 11
IV_SHAPE, IV_LVL = (256, 256), 39
PUB_SHAPE, PUB_LVL = (48, 44), 19


def spatial(n: int) -> tuple[int, int]:
    """The most-square power-of-two ``(ny, nx)``: 8 -> 2x4, 16 -> 4x4,
    32 -> 4x8."""
    ny = 1
    while ny * 2 <= n // (ny * 2):
        ny *= 2
    return ny, n // ny


def inputs(n: int) -> dict:
    """Every field of the run, made from one seeded generator."""
    from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    rng = np.random.default_rng(0)
    nb = n // 4 if n % 4 == 0 else 0
    imgs = rng.integers(0, 10, size=(max(2 * nb, 1),) + SHAPE).astype(np.uint8)
    seeds = [(3, 3), (20, 24), (12, 9)]
    ws = TransformBuilder().set_device("cpu").build_segmenting()
    iv = rng.integers(0, 40, size=IV_SHAPE).astype(np.uint8)
    pub = rng.integers(0, 20, size=PUB_SHAPE).astype(np.uint8)
    return dict(
        nb=nb, imgs=imgs, labels0=np.stack([paint_seeds(SHAPE, seeds)] * len(imgs)), n_seeds=len(seeds),
        nd=rng.integers(0, 12, size=ND_SHAPE).astype(np.uint8), nd_seeds=[(3, 3), (30, 40), (18, 7)],
        iv=iv, iv_seeds=ws.find_local_minima(iv), pub=pub, pub_seeds=ws.find_local_minima(pub),
    )


def rank_main(rank: int, n: int, data: dict) -> dict:
    """Every case of one rank (see the module docstring)."""
    from torch.distributed.device_mesh import DeviceMesh

    from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
    from rustronomy_watershed_tpu_torch.parallel import tiled_transform
    from rustronomy_watershed_tpu_torch.parallel.tiled import MeshLevelStepper
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    out = {}
    t = torch.from_numpy
    if data["nb"]:
        bmesh = DeviceMesh("cpu", torch.arange(n).reshape(data["nb"], 2, 2), mesh_dim_names=("batch", "y", "x"))
        kw = dict(n_labels=data["n_seeds"], max_water_level=BATCH_LVL, halo=2, axis_batch="batch")
        out["batch sizes"] = tuple(a.numpy() for a in tiled_transform(
            t(data["imgs"]), t(data["labels0"]), bmesh, merging=True, collect="sizes", **kw))
        for backend in ("packed", "relax"):
            out[("batch history", backend)] = tuple(a.numpy() for a in tiled_transform(
                t(data["imgs"]), t(data["labels0"]), bmesh, collect="history", backend=backend, **kw))
    smesh = DeviceMesh("cpu", torch.arange(n).reshape(spatial(n)), mesh_dim_names=("y", "x"))
    one = DeviceMesh("cpu", torch.arange(1).reshape(1, 1), mesh_dim_names=("y", "x"))
    nd_lab0 = t(paint_seeds(ND_SHAPE, data["nd_seeds"]))
    for merging in (False, True):
        for backend in ("packed", "relax"):
            out[("nd", merging, backend)] = tiled_transform(t(data["nd"]), nd_lab0, smesh, n_labels=3,
                                                            max_water_level=ND_LVL, merging=merging, halo=2,
                                                            backend=backend).numpy()
    stepper = MeshLevelStepper(smesh, n_labels=3, merging=True)
    img_p, lab = stepper.prepare(t(data["nd"]), nd_lab0)
    rounds = []
    for lvl in range(ND_LVL + 1):
        lab, r = stepper.step(img_p, lab, lvl)
        rounds.append(r)
    out["stepper"] = (stepper.crop(lab), rounds)
    iv_lab0 = t(paint_seeds(IV_SHAPE, data["iv_seeds"]))
    for name, mesh in (("1x1", one), ("spatial", smesh)):
        if mesh.get_coordinate() is not None:
            _, stats = tiled_transform(t(data["iv"]), iv_lab0, mesh, n_labels=len(data["iv_seeds"]),
                                       max_water_level=IV_LVL, with_stats=True)
            out[("rounds", name)] = stats[0]
    pub, pub_seeds = data["pub"], data["pub_seeds"]

    def built(variant):
        tb = TransformBuilder().set_device("cpu").set_max_water_lvl(PUB_LVL).enable_edge_correction().set_mesh(smesh)
        return getattr(tb, f"build_{variant}")()

    out["edge transform"] = built("segmenting").transform(pub, pub_seeds)
    out["edge list"] = built("merging").transform_to_list(pub, pub_seeds, counts_length=len(pub_seeds) + 1)
    out["edge history"] = built("segmenting").transform_history(pub, pub_seeds)
    return out


def same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"torch_mesh_dryrun: {what}")


def run(n: int, root: str) -> str:
    from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    data = inputs(n)
    t0 = time.perf_counter()
    res = run_ranks(rank_main, n, root, n, data, deadline=1200.0)
    wall = time.perf_counter() - t0
    for key in res[0]:
        if not isinstance(key, tuple) or key[0] != "rounds":
            expect(all(same(r[key], res[0][key]) for r in res), f"the ranks disagree on {key} at {n} ranks")
    parts = []
    if data["nb"]:
        kw = dict(n_labels=data["n_seeds"], max_water_level=BATCH_LVL, device="cpu")
        for key, merging, collect in (("batch sizes", True, "sizes"), (("batch history", "packed"), False, "history"),
                                      (("batch history", "relax"), False, "history")):
            want = [run_levels_impl(a, b, merging=merging, collect=collect, backend="relax", **kw)
                    for a, b in zip(data["imgs"], data["labels0"])]
            labels, stack = res[0][key]
            expect(same(labels, np.stack([w[0].numpy() for w in want])), f"{key} labels at {n} ranks")
            expect(same(stack, np.stack([w[1].numpy() for w in want], axis=1)), f"{key} statistics at {n} ranks")
        parts.append(f"batch mesh {(data['nb'], 2, 2)}: {len(data['imgs'])} images, sizes {res[0]['batch sizes'][1].shape}"
                     f", history {res[0][('batch history', 'relax')][1].shape} on the packed and the relax engine ok")
    ny, nx = spatial(n)
    from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds

    nd_lab0 = paint_seeds(ND_SHAPE, data["nd_seeds"])
    for merging in (False, True):
        want = run_levels_impl(data["nd"], nd_lab0, n_labels=3, max_water_level=ND_LVL, merging=merging,
                               backend="relax", device="cpu").numpy()
        for backend in ("packed", "relax"):
            expect(same(res[0][("nd", merging, backend)], want),
                   f"non-divisible {ND_SHAPE} merging={merging} backend={backend} at {n} ranks")
    expect(same(res[0]["stepper"][0], want), f"the per-level stepper at {n} ranks")
    r11, rs = res[0][("rounds", "1x1")], res[0][("rounds", "spatial")]
    expect(all(r[("rounds", "spatial")] == rs for r in res), f"the ranks disagree on the rounds at {n} ranks")
    expect(rs <= r11 + 1, f"{rs} exchange rounds on {ny}x{nx} against {r11} on 1x1 at {n} ranks")

    def single(variant):
        tb = TransformBuilder().set_device("cpu").set_max_water_lvl(PUB_LVL).enable_edge_correction()
        return getattr(tb, f"build_{variant}")()

    pub, pub_seeds = data["pub"], data["pub_seeds"]
    expect(same(res[0]["edge transform"], single("segmenting").transform(pub, pub_seeds)), "edge-corrected transform")
    expect(same(res[0]["edge list"], single("merging").transform_to_list(pub, pub_seeds,
                                                                         counts_length=len(pub_seeds) + 1)),
           "edge-corrected transform_to_list")
    expect(same(res[0]["edge history"], single("segmenting").transform_history(pub, pub_seeds)),
           "edge-corrected transform_history")
    parts.append(f"spatial {ny}x{nx}: non-divisible {ND_SHAPE} ok on both relax engines, per-level stepper ok (rounds "
                 f"{res[0]['stepper'][1]}), exchange rounds {rs} against {r11} on 1x1, edge-corrected transform, "
                 "to_list and history ok")
    return f"torch_mesh_dryrun OK [{n} ranks, {wall:.1f} s]: " + "; ".join(parts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[8, 16, 32])
    args = ap.parse_args()
    torch.set_num_threads(1)
    for n in args.sizes:
        with tempfile.TemporaryDirectory() as root:
            print(run(n, root), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
