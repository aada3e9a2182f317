#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (rustronomy_watershed_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from csrc/, holds each against its plain
PyTorch twin on the card (every call of the 4096^2 relax fixed points and of
the 4096^2 uniform and Poisson(30) flood level sweeps with quiet tiles
skipped, every coarse round of seven fields and of a 2048x16384 tail),
drives both main paths through the entry points a
user calls (the public builder API on the committed goldens, ``watershed_e2e``
on the 4096^2 u8 fields, ``transform_batch`` on 16 x 1024^2 cutouts) for the
segmenting and the merging variant, then the level-sweep engine
(``set_backend("pallas")``, the flood kernel) at 4096^2 and the per-level API
(``transform_to_list``, ``transform_history``, hooks, progress, plots) at
1024^2, checks the labels against the packed engine, then the fine scan tail
and the legacy coarse rounds against their twins, 16384^2 transforms
(the fine tail, relax at width 16384) against the exact engine, then the
single-device options (relax-plane checkpoints at 4096^2, interrupted and
resumed; per-level checkpoints on the flood kernel; the random tie-break on
the card against the CPU; the native engine), then the mesh: the relax
kernel's centre rectangle against its twin, ``set_mesh`` on a one-rank NCCL
mesh and on a 2 x 2 gloo mesh of four spawned processes sharing the card
(4096^2, both variants, every rank's labels against the single-device
labels; the per-level API and the host loop with a hook and progress on
golden_morph_v1, every relax call of the claims pass and every flood call
of the level loop against the twins; a (2, 1, 2) batch mesh's
``transform_batch``; JAX's jnp tiled relax engine ``backend='relax'`` on
both meshes), then ``utils.tracing.trace`` in a process of its own (the
4096^2 transforms' kernels counted in the trace file against the route
counters), the 4096^2 morphology field of ``tools/gen_golden_morph.py``'s
recipe (labels against the native engine, a corner against the NumPy
oracle, both computed in two processes of their own; ``pre_process_jnp`` on
the card against the CPU), then the relax kernel's y0 epilogue
(``fwd_scan=True``: the first call at 4096^2 and 16384^2 against the twin,
timed plain, with statistics and with y0; how often call 1 certifies; the
fine tail from y0), and times the card.
One line per phase; the line before the last is the kernel table as JSON,
the last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
the run exits non-zero; without CUDA it exits non-zero at once.  Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
import types
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
SIDE = 4096  # the benchmarked fields: bench.py's u8 inputs (dense, 10% NaN dots)
BIG = 16384  # the largest user tile (PERF.md section 1): one transform per variant
WIDE = (2048, BIG)  # 16384-long rows whose labels stay below 2**24 (the coarse tail)
# More fine and coarse rows than the 4096 grid rows of the scan kernels'
# cell launches, so that their row-stride loops run; the h-window binds.
TALL = (9001, 700)
# Rows wider than the fine row kernel's shared-memory ring: its chunked route.
PAST_CAP = (300, 18440)

# The least time the card could take (H100 SXM at 700 W): bytes over
# 3.35 TB/s, operations over 67 T/s (the peak rate outside the tensor cores,
# used for all 32-bit work).
HBM_BYTES_PER_MS = 3.35e9
OPS_PER_MS = 67e9


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: float, ops: float):
    """``(bound_ms, bound_by)``: the larger of the byte and operation times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, ops / OPS_PER_MS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


MESH_DEADLINE = 600.0  # seconds the ranks of the 2 x 2 mesh (phase 23) may take
TRACE_DEADLINE = 300.0  # seconds the tracing phase's process (phase 24) may take
# The morphology field (phase 25): tools/gen_golden_morph.py's recipe at
# MORPH^2 (golden_morph_v1 is the same recipe at 1024^2), its MORPH_CROP^2
# corner held against the NumPy oracle.
MORPH, MORPH_CROP, MORPH_SEED, MORPH_MAX = 4096, 256, 20260820, 20
MORPH_DEADLINE = 900.0  # seconds from their start the reference processes may take
ANNOTATION = "merging nan10"  # the step_annotation of phase 24


def morph_field(size: int):
    """``(float field, u8 image)``: ``tests/torch_fields.py::morph_field``
    (``tools/gen_golden_morph.py``'s recipe on the port's fields) at
    ``size``^2, quantised to 21 levels by the port's pre-processor."""
    from torch_fields import morph_field as recipe  # tests/, on sys.path since main()

    from rustronomy_watershed_tpu_torch.ops.preprocess import pre_process

    sm = recipe((size, size), MORPH_SEED)
    return sm, pre_process(sm, MORPH_MAX)


def morph_reference(variant: str, out_dir: str, size: int, crop_side: int) -> None:
    """One background process of phase 25: the native engine's ``variant``
    labels of the ``size``^2 morphology field and the NumPy oracle's of its
    ``crop_side``^2 corner, with their seeds and host seconds, into
    ``out_dir``; the segmenting process also writes the float field."""
    from rustronomy_watershed_tpu_torch.parity import native, oracle_find_local_minima, oracle_transform

    sm, img = morph_field(size)
    if variant == "segmenting":
        np.save(os.path.join(out_dir, "field.npy"), sm)
    merging = variant == "merging"
    t0 = time.perf_counter()
    seeds = native.native_find_local_minima(img)
    labels = native.native_transform(img, seeds, 254, merging=merging)
    native_s = time.perf_counter() - t0
    crop = img[:crop_side, :crop_side]
    t0 = time.perf_counter()
    crop_seeds = oracle_find_local_minima(crop)
    crop_labels, _ = oracle_transform(crop, crop_seeds, 254, merging=merging)
    oracle_s = time.perf_counter() - t0
    np.savez(os.path.join(out_dir, f"{variant}.npz"), img=img, seeds=np.asarray(seeds, np.int64).reshape(-1, 2),
             labels=np.asarray(labels, np.int32), crop_seeds=np.asarray(crop_seeds, np.int64).reshape(-1, 2),
             crop_labels=np.asarray(crop_labels, np.int32), native_s=native_s, oracle_s=oracle_s)


def start_morph_references() -> dict:
    """Start phase 25's two reference processes (``morph_reference``, one a
    variant; daemons, so they end with this process) writing into
    ``build/smoke_morph``: ``{"dir", "procs", "t0"}``."""
    import multiprocessing as mp

    out_dir = os.path.join(HERE, "build", "smoke_morph")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    procs = {variant: mp.get_context("spawn").Process(target=morph_reference, daemon=True,
                                                       args=(variant, out_dir, MORPH, MORPH_CROP))
             for variant in ("segmenting", "merging")}
    for proc in procs.values():
        proc.start()
    return {"dir": out_dir, "procs": procs, "t0": time.monotonic()}


# Device kernels of the traced transforms (phase 24), by a part of their
# demangled names, and the launches of each per count of its launch counter
# (a coarse round or a relax call that stopped on the device launched its
# kernels too).
TRACED_KERNELS = {
    "pack": ("pack_bands", "pack", 1),
    "relax": ("relax_kernel", "relax_launched", 1),
    "coarsen": ("coarsen_strips", "coarsen", 1),
    "coarse round column scans": ("vscan_tiles<true,", "coarse_round_launched", 2),
    "coarse round row kernel": ("row_ring<true>", "coarse_round_launched", 1),
    "coarse_broadcast": ("broadcast_rows", "coarse_broadcast", 1),
}


def read_trace(path) -> tuple[dict, set]:
    """A trace file's device kernel events by name (``{name: count}``) and
    the names of all its events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    return kernels, {e.get("name") for e in events}


def traced_rank(rank: int, log_root: str, side: int, device: str) -> dict:
    """Phase 24, a spawned process (one profiler session a process is the
    safe rule): one warm ``side``^2 segmenting ``watershed_e2e`` on the
    uniform field and one NaN-dot merging ``watershed_e2e`` under
    ``utils.tracing.trace``, the merging one inside a ``step_annotation``;
    the route counters of the traced call, its trace file's kernels, walls
    traced and untraced; then a second session in the same process."""
    import torch

    from rustronomy_watershed_tpu_torch import _ext
    from rustronomy_watershed_tpu_torch.ops.pipeline import watershed_e2e
    from rustronomy_watershed_tpu_torch.utils.tracing import step_annotation, trace, trace_artifacts

    dev = torch.device(device)
    rng = np.random.default_rng(0)  # the draws of main()'s 4096^2 fields
    img = rng.integers(0, 254, (side, side)).astype(np.uint8)
    dots = img.copy()
    dots[rng.random((side, side)) < 0.1] = 255
    img_d, dots_d = torch.from_numpy(img).to(dev), torch.from_numpy(dots).to(dev)

    def both():
        t0 = time.perf_counter()
        seg = watershed_e2e(img_d, device=dev)
        with step_annotation(ANNOTATION):
            mrg = watershed_e2e(dots_d, merging=True, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (seg, mrg), (time.perf_counter() - t0) * 1e3

    want, _ = both()  # warm: the kernel library is loaded and every plan made
    untraced = [both()[1] for _ in range(3)]
    res = {"untraced_ms": untraced}
    for session in ("first", "second"):
        log_dir = os.path.join(log_root, session)
        _ext.reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with trace(log_dir):
                got, wall = both()
        arts = trace_artifacts(log_dir)
        kernels, names = read_trace(arts[0]) if arts else ({}, set())
        res[session] = dict(
            wall_ms=wall, launches=dict(_ext.launches), same=all(torch.equal(a, b) for a, b in zip(got, want)),
            warnings=[str(c.message) for c in caught if issubclass(c.category, RuntimeWarning)],
            files=len(arts), bytes=sum(a.stat().st_size for a in arts), kernels=kernels, annotation=ANNOTATION in names)
    return res


def max_err(xs, ys) -> int:
    """The largest absolute difference between paired tensors."""
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0 for x, y in zip(xs, ys))


def held_mesh_calls(log: dict, keep_first: bool = False):
    """An ``on_call`` for the mesh driver (``parallel.tiled._tiled_run``):
    holds each relax call, planes and flags, against the twin on the same
    inputs and rectangle, and adds to ``log``'s ``calls`` and ``err``.
    With ``keep_first``, ``log["first"]`` keeps a copy of the first call's
    inputs and rectangle (for timing the kernel at the path's shape)."""
    from rustronomy_watershed_tpu_torch.ops import relax

    def on_call(v, src, dst, flags, ctr):
        steps = ctr[0]  # k sweeps a round on planes with a k-px halo
        if keep_first and "first" not in log:
            log["first"] = (v.clone(), src[0].clone(), src[1].clone(), ctr)
        want = relax.relax_block_plain(v, *src, steps, ctr=ctr)
        log["err"] = max(log.get("err", 0), max_err((*dst, flags), want))
        log["calls"] = log.get("calls", 0) + 1

    return on_call


def held_flood_calls(log: dict, steps: int):
    """An ``on_call`` for the mesh's level loop
    (``parallel.tiled.MeshLevelStepper``): holds each flood call, plane and
    flags, against the twin on the same inputs and ``steps``, and adds to
    ``log``'s ``calls`` and ``err``."""
    from rustronomy_watershed_tpu_torch.ops import flood_block

    def on_call(v, src, dst, flags, lvl):
        want = flood_block.flood_block_plain(v, src, lvl, steps)
        log["err"] = max(log.get("err", 0), max_err((dst, flags), want))
        log["calls"] = log.get("calls", 0) + 1

    return on_call


def sha(a) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def hook_digest(ctx):
    """A hook's view in a few bytes: the level, the labels' digest and the
    last seed."""
    return ctx.water_level, sha(ctx.colours), ctx.seeds[-1] if ctx.seeds else None


def level_refs(ws_of, img, seeds, variant: str) -> dict:
    """The single device's per-level results of ``variant`` on ``img``,
    digested as ``level_paths`` digests the mesh's; ``ws_of(variant,
    **setters)`` builds on the card."""
    rows = ws_of(variant).transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    return dict(list=([lvl for lvl, _ in rows], sha(np.stack([r for _, r in rows]))),
                history=[(lvl, sha(p)) for lvl, p in ws_of(variant).transform_history(img, seeds)],
                hooks=ws_of(variant, set_wlvl_hook=(hook_digest,)).transform_with_hook(img, seeds),
                labels=sha(ws_of(variant).transform(img, seeds)))


def level_paths(mesh, dev, img, seeds, variant: str) -> dict:
    """The per-level API and the host loop of ``variant`` on ``mesh`` (phase
    22 in the smoke's process, phase 23 on each rank): ``transform_to_list``
    and ``transform_history`` through the compact route, with every relax
    call of its tiled claims pass held against the twin; the host loop with
    a hook and progress through the builder, its launch counts and wall;
    and the same levels stepped on ``MeshLevelStepper`` with every flood
    call held against the twin, its rounds a level and final labels."""
    import contextlib
    import io

    import torch

    from rustronomy_watershed_tpu_torch import _ext
    from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
    from rustronomy_watershed_tpu_torch.parallel.tiled import MeshLevelStepper, _tiled_run
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    def ws_of(**setters):
        tb = TransformBuilder().set_device(dev).set_mesh(mesh)
        for setter, args in setters.items():
            getattr(tb, setter)(*args)
        return getattr(tb, f"build_{variant}")()

    def wall(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    res, n = {}, len(seeds)
    rows, res["list_ms"] = wall(lambda: ws_of().transform_to_list(img, seeds, counts_length=n + 1))
    res["list"] = ([lvl for lvl, _ in rows], sha(np.stack([r for _, r in rows])))
    snaps, res["history_ms"] = wall(lambda: ws_of().transform_history(img, seeds))
    res["history"] = [(lvl, sha(p)) for lvl, p in snaps]
    del rows, snaps
    img_t = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
    lab_t = torch.from_numpy(paint_seeds(img.shape, seeds)).to(dev)
    held = {}
    _tiled_run(img_t, lab_t, mesh, n_labels=n, max_water_level=254, collect="claims", on_call=held_mesh_calls(held))
    res["claims_held"] = held
    hooked = ws_of(set_wlvl_hook=(hook_digest,), enable_progress=())
    _ext.reset_launches()
    bar = io.StringIO()
    with contextlib.redirect_stderr(bar):
        res["hooks"], res["loop_ms"] = wall(lambda: hooked.transform_with_hook(img, seeds))
    res["loop_launches"], res["bar"] = dict(_ext.launches), bar.getvalue()
    fheld = {}
    stepper = MeshLevelStepper(mesh, n_labels=n, merging=variant == "merging", on_call=held_flood_calls(fheld, 4))
    v_p, lab = stepper.prepare(img_t, lab_t)
    rounds = []
    for lvl in range(255):
        lab, r = stepper.step(v_p, lab, lvl)
        rounds.append(r)
    res.update(flood_held=fheld, rounds=rounds, labels=sha(stepper.crop(lab)))
    return res


def mesh_flood_path(counts: dict) -> bool:
    """Whether a mesh host loop's launch counts show the flood kernel and no
    plain twin."""
    from rustronomy_watershed_tpu_torch import _ext

    return counts["flood"] > 0 and sum(counts[f"{k}_plain"] for k in _ext.KERNELS) == 0


def check_levels(got: dict, want: dict, what: str, root: bool = True) -> None:
    """``level_paths``'s results against ``level_refs``'s; the progress bar
    on mesh rank 0 (``root``) alone."""
    check(got["list"] == want["list"], f"{what}: transform_to_list == the single device's")
    check(got["history"] == want["history"], f"{what}: transform_history == the single device's")
    check(got["hooks"] == want["hooks"], f"{what}: the host loop's hook views == the single device's")
    check(("water level 254/254" in got["bar"]) if root else got["bar"] == "",
          f"{what}: {'the bar reached level 254' if root else 'no bar off mesh rank 0'}")
    check(got["labels"] == want["labels"], f"{what}: MeshLevelStepper's labels == the single device's")
    check(got["claims_held"].get("calls", 0) > 0 and got["claims_held"]["err"] == 0,
          f"{what}: every relax call of the claims pass == twin on the same inputs and rectangle")
    check(got["flood_held"]["calls"] == sum(got["rounds"]) and got["flood_held"]["err"] == 0,
          f"{what}: every flood call of MeshLevelStepper == twin on the same inputs (planes and flags)")


def mesh_rank(rank: int, device: str, cases, level_cases=(), batch=None, relax_cases=()) -> dict:
    """One rank of phase 23's 2 x 2 gloo mesh, a spawned process
    (``tests/torch_mesh.py::run_ranks``), computing its tile on ``device``.
    Per case ``(variant, image, seeds)``: every relax call of the mesh
    driver held against the twin, the labels' sha256, the rounds and tile
    calls, the API transform's wall and its launch counts.  Per level case
    ``(variant, image, seeds)``: ``level_paths``.  ``batch``, ``(images,
    seed lists)``: ``transform_batch`` on a (2, 1, 2) batch mesh, its
    labels' digest and wall.  Per relax case ``(variant, image, seeds)``:
    ``tiled_transform`` on ``backend='relax'`` and on ``'packed'``, each
    one's labels' digest, rounds, wall and launch counts."""
    import torch
    import torch.distributed as dist

    from rustronomy_watershed_tpu_torch import _ext
    from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
    from rustronomy_watershed_tpu_torch.parallel.tiled import _tiled_run
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
    from torch_mesh import mesh_of

    mesh = mesh_of((2, 2))
    dev = torch.device(device)
    res = {"backends": [dist.get_backend(mesh.get_group(d)) for d in ("y", "x")]}
    for variant, field, seeds in cases:
        held = {}
        _, stats, _ = _tiled_run(torch.from_numpy(field).to(dev), torch.from_numpy(paint_seeds(field.shape, seeds)).to(dev),
                                 mesh, n_labels=len(seeds), max_water_level=254, merging=variant == "merging",
                                 on_call=held_mesh_calls(held))
        ws = getattr(TransformBuilder().set_device(dev).set_mesh(mesh), f"build_{variant}")()
        _ext.reset_launches()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = ws.transform(field, seeds)
        wall = (time.perf_counter() - t0) * 1e3
        res[variant] = dict(sha=hashlib.sha256(labels.tobytes()).hexdigest(), rounds=stats[0], runs=stats[1],
                            wall_ms=wall, launches=dict(_ext.launches), held=held)
    for variant, field, seeds in level_cases:
        res[("levels", variant)] = level_paths(mesh, dev, field, seeds, variant)
    if batch is not None:
        from torch.distributed.device_mesh import DeviceMesh

        bmesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 1, 2), mesh_dim_names=("batch", "y", "x"))
        imgs, seed_lists = batch
        for variant in ("segmenting", "merging"):
            wsb = getattr(TransformBuilder().set_device(dev).set_mesh(bmesh), f"build_{variant}")()
            _ext.reset_launches()
            t0 = time.perf_counter()
            out = wsb.transform_batch(imgs, seed_lists)
            res[("batch", variant)] = dict(sha=sha(out), wall_ms=(time.perf_counter() - t0) * 1e3,
                                           launches=dict(_ext.launches))
    for variant, field, seeds in relax_cases:
        f_t, l_t = torch.from_numpy(field).to(dev), torch.from_numpy(paint_seeds(field.shape, seeds)).to(dev)
        res[("relax", variant)] = {}
        for backend in ("relax", "packed"):
            _ext.reset_launches()
            t0 = time.perf_counter()
            labels, stats, _ = _tiled_run(f_t, l_t, mesh, n_labels=len(seeds), max_water_level=254,
                                          merging=variant == "merging", backend=backend)
            res[("relax", variant)][backend] = dict(sha=sha(labels.cpu().numpy()), rounds=stats[0],
                                                    ms=(time.perf_counter() - t0) * 1e3, launches=dict(_ext.launches))
    return res


def mesh_kernel_path(counts: dict) -> bool:
    """Whether a mesh transform's launch counts show the relax kernel, each
    launch with its centre rectangle, and no plain twin."""
    from rustronomy_watershed_tpu_torch import _ext

    plain = sum(counts[f"{k}_plain"] for k in _ext.KERNELS)
    return counts["relax"] > 0 and counts["relax_ctr"] == counts["relax"] and plain == 0


def mesh_phases(c) -> dict:
    """Phases 21-23: the relax kernel's centre rectangle against its twin,
    then the port's mesh on the card (a one-rank NCCL mesh, then a 2 x 2
    gloo mesh of four processes on the one card, and a (2, 1, 2) gloo batch
    mesh).  ``c`` holds what they take from the earlier phases: the device
    and its line, helpers, the segmenting builder ``ws``, phase 4's packed
    4096^2 planes, the 4096^2 uniform and 10% NaN-dot fields and
    golden_morph_v1 with its seeds (the per-level API and the host loop:
    1024^2 on the one-rank mesh, its 512^2 quadrants on four ranks).
    Returns the relax_ctr row's numbers: its launches on the 1 x 1 mesh's
    segmenting transform, its error over every relax call of the mesh
    driver in phases 22 and 23 (the claims passes included; against the
    twin on the same inputs), and its times and bound on the 1 x 1 mesh's
    first call (the padded 4112^2 planes, its rectangle); and the flood
    row's part: the error over every flood call of ``MeshLevelStepper`` in
    both phases and the flood launches of the 1 x 1 mesh's segmenting host
    loop."""
    import torch

    from rustronomy_watershed_tpu_torch import _ext
    from rustronomy_watershed_tpu_torch.ops import pack, relax
    from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    dev, gpu, to_dev, median_ms, timed = c.dev, c.gpu, c.to_dev, c.median_ms, c.timed
    builder, ws, v, key0, lab0 = c.builder, c.ws, c.v, c.key0, c.lab0
    pimg, pseeds, flood_err = c.pimg, c.pseeds, 0
    img_np, dots, s = c.img_np, c.dots, relax.DEFAULT_STEPS
    # -- 21: the relax kernel's centre rectangle against its twin -------------
    ctr_err = 0
    odd_c = np.random.default_rng(21).integers(0, 254, (1023, 1031)).astype(np.uint8)
    for label, (vv, kk, ll) in ((f"uniform {SIDE}^2", (v, key0, lab0)),
                                ("uniform 1023x1031", pack.pack_kernel(to_dev(odd_c))[:3])):
        h, w = kk.shape
        mid_c = relax.relax_block_kernel(vv, kk, ll, 5)[:2]
        rects = {"the whole plane": (0, h, 0, w), "inner (8, h-8, 8, w-8)": (8, h - 8, 8, w - 8),
                 "off-centre (37, h-50, 13, w-101)": (37, h - 50, 13, w - 101)}
        for rname, rect in rects.items():
            for state in ((kk, ll), mid_c):
                got = relax.relax_block_kernel(vv, *state, s, ctr=rect)
                want = relax.relax_block_plain(vv, *state, s, ctr=rect)
                torch.cuda.synchronize()
                ctr_err = max(ctr_err, max_err(got, want))
            skips = []

            def held_ctr(src, dst, flags, skipped, vv=vv, rect=rect, skips=skips):
                nonlocal ctr_err
                ctr_err = max(ctr_err, max_err((*dst, flags), relax.relax_block_plain(vv, *src, s, ctr=rect)))
                skips.append(skipped)

            relax.relax_fixed_point(vv, kk.clone(), ll.clone(), ctr=rect, on_call=held_ctr)
            check(ctr_err == 0, f"relax kernel with the rectangle {rname} == twin on {label}")
            check(len(skips) >= 2 and skips[0] == 0, f"the {label} fixed point ran both ping-pong directions")
            print(f"[21 relax ctr] {label}, rectangle {rname} {rect}: fresh and mid calls and all {len(skips)} calls of "
                  f"the skipping fixed point bit-equal to the twin (planes and flags); tiles skipped per call {skips}")
    full_rect, inner_rect = (0, SIDE, 0, SIDE), (8, SIDE - 8, 8, SIDE - 8)
    ctr_times = {"none": [], "whole plane": [], "inner": []}
    for _ in range(2):  # in turns
        for name_, rect in (("none", None), ("whole plane", full_rect), ("inner", inner_rect)):
            ctr_times[name_].append(median_ms(lambda: relax.relax_block_kernel(v, key0, lab0, s, ctr=rect), 20))
    print(f"[21 time] relax {SIDE}^2 one call of {s} sweeps (median of 20, two turns): no rectangle "
          f"{ctr_times['none']} ms, the whole plane as rectangle {ctr_times['whole plane']} ms, inner rectangle "
          f"{ctr_times['inner']} ms; gpu={gpu}")

    # -- 22: the mesh on the card: a one-rank NCCL mesh -------------------------
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from rustronomy_watershed_tpu_torch.ops.seeds import seed_array
    from rustronomy_watershed_tpu_torch.parallel.tiled import _tiled_run

    mesh_root = os.path.join(HERE, "build", "smoke_mesh")
    shutil.rmtree(mesh_root, ignore_errors=True)
    os.makedirs(mesh_root)
    mesh_cases = [("segmenting", f"uniform {SIDE}^2", img_np), ("merging", f"10% 255-dots {SIDE}^2", dots)]
    mesh_seeds = {variant: seed_array(ws.find_local_minima(field)) for variant, _, field in mesh_cases}
    single_labels, mesh_err = {}, 0
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(mesh_root, "nccl"), 1), rank=0, world_size=1,
                            timeout=timedelta(seconds=120))
    try:
        mesh1 = DeviceMesh("cuda", [[0]], mesh_dim_names=("y", "x"))
        check(dist.get_backend(mesh1.get_group("y")) == "nccl", "the one-rank mesh runs on NCCL")
        for variant, label, field in mesh_cases:
            sd = mesh_seeds[variant]
            single = builder(variant)
            want = single.transform(field, sd, device_output=True)
            single_labels[variant] = want.cpu().numpy()
            meshed = getattr(TransformBuilder().set_device(dev).set_mesh(mesh1), f"build_{variant}")()
            _ext.reset_launches()
            got = meshed.transform(field, sd, device_output=True)
            torch.cuda.synchronize()
            counts = dict(_ext.launches)
            check(got.device == want.device and torch.equal(got, want), f"1x1 NCCL mesh {variant} {label} == single device")
            check(mesh_kernel_path(counts), f"the 1x1 mesh ({variant}) launched the relax kernel with its centre "
                  "rectangle and no twin")
            if variant == "segmenting":
                mesh_counts = counts
            held = {}
            run_labels, (rounds, runs), _ = _tiled_run(
                to_dev(field), to_dev(paint_seeds(field.shape, sd)), mesh1, n_labels=len(sd), max_water_level=254,
                merging=variant == "merging", on_call=held_mesh_calls(held, keep_first=variant == "segmenting"))
            check(torch.equal(run_labels, want), f"1x1 mesh driver {variant} == single device")
            check(held["calls"] == runs and held["err"] == 0,
                  f"every relax call of the 1x1 mesh driver ({variant}) == twin on the same inputs and rectangle")
            mesh_err = max(mesh_err, held["err"])
            if variant == "segmenting":
                first_call = held["first"]
            walls = {"single device": [], "1x1 mesh": []}
            for _ in range(3):
                walls["single device"].append(timed(lambda: single.transform(field, sd, device_output=True))[1])
                walls["1x1 mesh"].append(timed(lambda: meshed.transform(field, sd, device_output=True))[1])
            print(f"[22 mesh 1x1] {label} {variant}: set_mesh(one-rank NCCL DeviceMesh) transform == the single-device "
                  f"transform; {rounds} rounds, {runs} tile calls, each relax call bit-equal to the twin (planes and "
                  f"flags); relax launches {counts['relax']} (all with the centre rectangle); API wall ms (median of "
                  f"3 in turns) single device {np.median(walls['single device']):.1f}, 1x1 mesh "
                  f"{np.median(walls['1x1 mesh']):.1f}; runs {walls}; gpu={gpu}")
        # The per-level API and the host loop on the one-rank mesh, golden_morph_v1.
        for variant in ("segmenting", "merging"):
            want = level_refs(builder, pimg, pseeds, variant)
            single = builder(variant)
            list_1 = timed(lambda: single.transform_to_list(pimg, pseeds, counts_length=len(pseeds) + 1))[1]
            hist_1 = timed(lambda: single.transform_history(pimg, pseeds))[1]
            got = level_paths(mesh1, dev, pimg, pseeds, variant)
            check_levels(got, want, f"1x1 NCCL mesh {variant} golden_morph_v1 {pimg.shape}")
            check(mesh_flood_path(got["loop_launches"]), f"the 1x1 mesh's host loop ({variant}) launched the flood "
                  "kernel and no twin")
            mesh_err = max(mesh_err, got["claims_held"]["err"])
            flood_err = max(flood_err, got["flood_held"]["err"])
            if variant == "segmenting":
                flood_launches = got["loop_launches"]["flood"]
            n_lv = len(got["rounds"])
            print(f"[22 mesh 1x1 levels] golden_morph_v1 {pimg.shape} {variant}: transform_to_list, transform_history "
                  f"(compact route; {got['claims_held']['calls']} relax calls of the claims pass, each bit-equal to the "
                  f"twin) and the host loop with a hook and progress == the single device; MeshLevelStepper's "
                  f"{got['flood_held']['calls']} flood calls each bit-equal to the twin; the host loop launched flood "
                  f"{got['loop_launches']['flood']} times; rounds a level {sum(got['rounds']) / n_lv:.2f} (max "
                  f"{max(got['rounds'])}); gpu={gpu}")
            print(f"[22 time] golden_morph_v1 {pimg.shape} {variant} API wall ms: to_list 1x1 mesh "
                  f"{got['list_ms']:.1f} (single device {list_1:.1f}), history {got['history_ms']:.1f} (single device "
                  f"{hist_1:.1f}); host loop with hook and progress {got['loop_ms']:.1f}, "
                  f"{got['loop_ms'] / n_lv:.3f} ms a level; gpu={gpu}")
        # JAX's jnp tiled relax engine (backend='relax'): plain torch ops on
        # the card, no kernel; beside the packed engine on the same inputs.
        relax_cases = [("segmenting", f"uniform {SIDE}^2", img_np, mesh_seeds["segmenting"], single_labels["segmenting"])]
        relax_cases += [(variant, f"golden_morph_v1 {pimg.shape}", pimg, pseeds, builder(variant).transform(pimg, pseeds))
                        for variant in ("segmenting", "merging")]
        for variant, label, field, sd, want in relax_cases:
            f_t, l_t = to_dev(field), to_dev(paint_seeds(field.shape, sd))
            runs = {}
            for backend in ("relax", "packed"):
                _ext.reset_launches()
                (got, stats, starved), ms = timed(lambda: _tiled_run(
                    f_t, l_t, mesh1, n_labels=len(sd), max_water_level=254, merging=variant == "merging",
                    backend=backend))
                runs[backend] = dict(rounds=stats[0], ms=ms, launches=dict(_ext.launches))
                check(got.device == f_t.device and np.array_equal(got.cpu().numpy(), want) and not starved,
                      f"1x1 NCCL mesh backend={backend!r} {variant} {label} == single device")
            counts = runs["relax"]["launches"]
            check(sum(counts[k] + counts[f"{k}_plain"] for k in _ext.KERNELS) == 0,
                  f"backend='relax' ({variant} {label}) launched no kernel and no twin")
            check(mesh_kernel_path(runs["packed"]["launches"]), f"backend='packed' ({variant} {label}) launched relax")
            print(f"[22 mesh relax] {label} {variant}: tiled_transform(backend='relax') on the 1x1 NCCL mesh == single "
                  f"device, plain torch ops, no kernel launched; {runs['relax']['rounds']} rounds of {s} sweeps "
                  f"{runs['relax']['ms']:.1f} ms, against backend='packed' {runs['packed']['rounds']} rounds "
                  f"{runs['packed']['ms']:.1f} ms (wall, one run each); gpu={gpu}")
    finally:
        dist.destroy_process_group()

    # -- 23: a 2x2 gloo mesh of four processes on the one card ------------------
    from torch_mesh import run_ranks  # tests/, on sys.path since main()

    _ext.lib()  # built here once; the ranks load it
    cases = [(variant, field, mesh_seeds[variant]) for variant, _, field in mesh_cases]
    # The per-level paths on golden_morph_v1's top-left quadrant; the batch
    # mesh on its four quadrants.
    qh, qw = pimg.shape[0] // 2, pimg.shape[1] // 2
    quads = np.stack([pimg[y : y + qh, x : x + qw] for y in (0, qh) for x in (0, qw)])
    quad_seeds = [ws.find_local_minima(q) for q in quads]
    level_cases = [(variant, quads[0], quad_seeds[0]) for variant in ("segmenting", "merging")]
    level_want = {variant: level_refs(builder, quads[0], quad_seeds[0], variant) for variant in ("segmenting", "merging")}
    batch_want = {variant: sha(builder(variant).transform_batch(quads, quad_seeds)) for variant in ("segmenting", "merging")}
    t0 = time.perf_counter()
    ranks_out = run_ranks(mesh_rank, 4, mesh_root, str(dev), cases, level_cases, (quads, quad_seeds), level_cases,
                          deadline=MESH_DEADLINE)
    spawn_s = time.perf_counter() - t0
    for variant, label, _ in mesh_cases:
        want_sha = hashlib.sha256(single_labels[variant].tobytes()).hexdigest()
        per = [r[variant] for r in ranks_out]
        check(all(p["sha"] == want_sha for p in per), f"every rank's 2x2 mesh {variant} labels == single device")
        check(all(mesh_kernel_path(p["launches"]) for p in per),
              f"every rank launched the relax kernel with its centre rectangle and no twin ({variant})")
        check(all(r["backends"] == ["gloo", "gloo"] for r in ranks_out), "the 2x2 mesh's groups are gloo")
        check(all(p["held"]["calls"] > 0 and p["held"]["err"] == 0 for p in per),
              f"every relax call of every rank's mesh driver ({variant}) == twin on the same inputs and rectangle")
        mesh_err = max([mesh_err] + [p["held"]["err"] for p in per])
        print(f"[23 mesh 2x2] {label} {variant}: four gloo ranks (processes) computing {SIDE // 2}^2 tiles on one card, halo "
              f"strips, reductions and the all-gather through gloo and host memory: every rank's labels == the "
              f"single-device labels; {per[0]['rounds']} rounds, {per[0]['runs']} tile calls, each of the ranks' relax "
              f"calls {[p['held']['calls'] for p in per]} bit-equal to the twin; relax launches per rank "
              f"{[p['launches']['relax'] for p in per]}; API wall ms per rank {[round(p['wall_ms'], 1) for p in per]}; "
              f"gpu={gpu}")
    for variant in ("segmenting", "merging"):
        per = [r[("levels", variant)] for r in ranks_out]
        for rank, got in enumerate(per):
            check_levels(got, level_want[variant], f"2x2 gloo mesh rank {rank} {variant} {quads[0].shape}", rank == 0)
            check(mesh_flood_path(got["loop_launches"]), f"rank {rank}'s host loop ({variant}) launched the flood "
                  "kernel and no twin")
        mesh_err = max([mesh_err] + [p["claims_held"]["err"] for p in per])
        flood_err = max([flood_err] + [p["flood_held"]["err"] for p in per])
        n_lv = len(per[0]["rounds"])
        print(f"[23 mesh 2x2 levels] golden_morph_v1 quadrant {quads[0].shape} {variant}: on every rank to_list, "
              f"history and the host loop with a hook and progress == the single device, MeshLevelStepper's labels "
              f"too; relax calls of the claims pass per rank {[p['claims_held']['calls'] for p in per]} and flood "
              f"calls {[p['flood_held']['calls'] for p in per]}, each bit-equal to the twin; rounds a level "
              f"{sum(per[0]['rounds']) / n_lv:.2f}; gpu={gpu}")
        print(f"[23 time] quadrant {quads[0].shape} {variant} wall ms per rank: to_list "
              f"{[round(p['list_ms'], 1) for p in per]}, history {[round(p['history_ms'], 1) for p in per]}, host "
              f"loop {[round(p['loop_ms'], 1) for p in per]} ({per[0]['loop_ms'] / n_lv:.3f} ms a level on rank 0); "
              f"gpu={gpu}")
        bat = [r[("batch", variant)] for r in ranks_out]
        check(all(b["sha"] == batch_want[variant] for b in bat), f"(2, 1, 2) batch mesh {variant} transform_batch of "
              "4 quadrants == the single device's, on every rank")
        check(all(mesh_kernel_path(b["launches"]) for b in bat), f"the batch mesh ({variant}) launched the relax "
              "kernel with its centre rectangle and no twin")
        print(f"[23 mesh batch] (2, 1, 2) gloo batch mesh, 4 x {quads[0].shape} {variant} transform_batch == the single "
              f"device's on every rank; relax launches per rank {[b['launches']['relax'] for b in bat]}; wall ms "
              f"per rank {[round(b['wall_ms'], 1) for b in bat]}; gpu={gpu}")
    for variant in ("segmenting", "merging"):
        per = [r[("relax", variant)] for r in ranks_out]
        check(all(p["relax"]["sha"] == p["packed"]["sha"] == level_want[variant]["labels"] for p in per),
              f"every rank's 2x2 gloo mesh backend='relax' and 'packed' {variant} labels == single device")
        check(all(sum(p["relax"]["launches"][k] + p["relax"]["launches"][f"{k}_plain"] for k in _ext.KERNELS) == 0
                  for p in per), f"backend='relax' ({variant}) launched no kernel and no twin on any rank")
        print(f"[23 mesh relax] golden_morph_v1 quadrant {quads[0].shape} {variant}: tiled_transform(backend='relax') "
              f"on every rank of the 2x2 gloo mesh == single device, no kernel launched; {per[0]['relax']['rounds']} "
              f"rounds, wall ms per rank {[round(p['relax']['ms'], 1) for p in per]}, against backend='packed' "
              f"{per[0]['packed']['rounds']} rounds, {[round(p['packed']['ms'], 1) for p in per]}; gpu={gpu}")
    print(f"[23 mesh 2x2] spawn, import, both variants twice, the level paths, the batch mesh, both relax engines and "
          f"exit: {spawn_s:.1f} s")
    shutil.rmtree(mesh_root)

    # The relax_ctr row's times: the 1x1 mesh's first call, at its shape.
    v1, k1, l1, rect1 = first_call
    ctr_ms = float(np.median([median_ms(lambda: relax.relax_block_kernel(v1, k1, l1, rect1[0], ctr=rect1), 20)
                              for _ in range(2)]))
    ctr_plain_ms = median_ms(lambda: relax.relax_block_plain(v1, k1, l1, rect1[0], ctr=rect1), 5)
    px1 = k1.numel()
    ctr_bound = bound(px1 * (1 + 8 + 8), px1 * rect1[0] * 25)  # as the relax row's, at this plane
    print(f"[23 time] relax on the 1x1 mesh's first call ({tuple(k1.shape)} planes, rectangle {rect1}, {rect1[0]} "
          f"sweeps): kernel {ctr_ms:.4f} ms (median of 20, two turns), plain {ctr_plain_ms:.3f} ms, bound "
          f"{ctr_bound[0]:.4f} ms ({ctr_bound[1]}); gpu={gpu}")
    return dict(launches=mesh_counts["relax_ctr"], err=mesh_err, ms=ctr_ms, plain_ms=ctr_plain_ms, bound=ctr_bound,
                flood_err=flood_err, flood_launches=flood_launches)


def late_phases(c) -> None:
    """Phases 24-25: ``utils.tracing.trace`` on the card in a process of its
    own, then the 4096^2 morphology field against the references of
    ``start_morph_references``, started after the last timed phase so that
    no time of the smoke is taken beside them.  ``c`` holds the device and
    its line, helpers and the segmenting builder ``ws``."""
    import torch

    from rustronomy_watershed_tpu_torch import _ext

    dev, gpu, to_dev, timed, builder, ws = c.dev, c.gpu, c.to_dev, c.timed, c.builder, c.ws
    # -- 24: utils.tracing.trace on the card, in a process of its own ----------
    from torch_mesh import run_ranks  # tests/, on sys.path since main()

    trace_root = os.path.join(HERE, "build", "smoke_trace")
    shutil.rmtree(trace_root, ignore_errors=True)
    os.makedirs(trace_root)
    t0 = time.perf_counter()
    (tr,) = run_ranks(traced_rank, 1, trace_root, trace_root, SIDE, str(dev), deadline=TRACE_DEADLINE)
    trace_s = time.perf_counter() - t0
    first, second = tr["first"], tr["second"]
    check(first["same"] and second["same"], "the traced transforms' labels == the untraced ones'")
    check(first["warnings"] == [], f"the first session raised no RuntimeWarning: {first['warnings']}")
    check(first["files"] == 1 and first["bytes"] > 0 and first["annotation"],
          f"the first session left one trace file holding the step annotation {ANNOTATION!r}")
    routes = first["launches"]
    check(routes["pack_vec"] == routes["pack"] and routes["coarsen_vec"] == routes["coarsen"]
          and routes["coarse_broadcast_vec"] == routes["coarse_broadcast"]
          and routes["coarse_round_ring"] == routes["coarse_round_launched"] and routes["merge_tail"] == 1,
          "the traced transforms took the vector routes, the ring rounds and the merging tail")
    traced = {}
    for what, (part, counter, per) in TRACED_KERNELS.items():
        n = sum(c for k, c in first["kernels"].items() if part in k)
        traced[what] = (n, per * routes[counter])
        check(n == per * routes[counter] > 0, f"the trace holds {what}'s {per} x {routes[counter]} launches ({n})")
    n2 = sum(second["kernels"].values())
    warned2 = any("no kernel on the device" in w for w in second["warnings"])
    check((n2 > 0 and not second["warnings"]) or (n2 == 0 and warned2 and second["files"] == 1),
          f"the second session: device kernels and no warning, or none and the RuntimeWarning ({n2}, "
          f"{second['warnings']})")
    print(f"[24 trace] utils.tracing.trace around one {SIDE}^2 segmenting and one 10% NaN-dot merging watershed_e2e "
          f"(step_annotation {ANNOTATION!r}) in a spawned process: no warning; the trace file ({first['bytes']} bytes) "
          f"holds the annotation and each kernel at its route counters' launches (traced, route): "
          + ", ".join(f"{k} {a}/{b}" for k, (a, b) in traced.items()) + f"; gpu={gpu}")
    case = (f"{n2} device kernel events and no warning" if n2 else
            "no device kernel event, and the RuntimeWarning came" if warned2 else "no device kernel event, no warning")
    print(f"[24 trace] a second session in the same process: {case}; its file {second['bytes']} bytes")
    print(f"[24 time] the two transforms' wall: untraced {[round(t, 2) for t in tr['untraced_ms']]} ms, traced "
          f"{first['wall_ms']:.2f} ms (first session), {second['wall_ms']:.2f} ms (second); the phase {trace_s:.1f} s; "
          f"gpu={gpu}")
    shutil.rmtree(trace_root)

    # -- 25: the 4096^2 morphology field --------------------------------------
    from rustronomy_watershed_tpu_torch.ops.preprocess import pre_process, pre_process_jnp

    # The native engine takes minutes at 4096^2 on one host thread: this
    # process waits for the two references and then times the card alone.
    morph = start_morph_references()
    for variant, proc in morph["procs"].items():
        proc.join(timeout=max(1.0, MORPH_DEADLINE - (time.monotonic() - morph["t0"])))
        check(proc.exitcode == 0, f"the {variant} reference process finished ({proc.exitcode})")
    print(f"[25 morph] the references (the native engine on the {MORPH}^2 field and the NumPy oracle on its "
          f"{MORPH_CROP}^2 corner, a process for each variant) took {time.monotonic() - morph['t0']:.1f} s of waiting")
    ref = {variant: np.load(os.path.join(morph["dir"], f"{variant}.npz")) for variant in morph["procs"]}
    sm_field = np.load(os.path.join(morph["dir"], "field.npy"))
    mimg = pre_process(sm_field, MORPH_MAX)
    check(all(np.array_equal(mimg, r["img"]) for r in ref.values()), "the morphology field rebuilt equally")
    mseeds = ws.find_local_minima(mimg)
    check(np.array_equal(np.asarray(mseeds, np.int64).reshape(-1, 2), ref["segmenting"]["seeds"]),
          "the card's seeds of the morphology field == the native engine's")
    crop = mimg[:MORPH_CROP, :MORPH_CROP]
    cseeds = ws.find_local_minima(crop)
    for variant in ("segmenting", "merging"):
        r = ref[variant]
        wsv = builder(variant)
        wsv.transform(mimg, mseeds)  # warm
        _ext.reset_launches()
        got, m_ms = timed(lambda: wsv.transform(mimg, mseeds))
        counts = dict(_ext.launches)
        check(np.array_equal(got, r["labels"]), f"{MORPH}^2 morphology {variant} on the card == the native engine")
        check(counts["relax"] > 0, f"the morphology {variant} transform launched relax")
        if counts["merge_tail"]:
            check(all(counts[k] > 0 for k in ("coarsen", "coarse_round", "coarse_broadcast")),
                  "the morphology merging tail launched the coarse kernels")
        check(sum(counts[f"{k}_plain"] for k in _ext.KERNELS) == 0, f"no plain twin on the morphology {variant} transform")
        check(np.array_equal(np.asarray(cseeds, np.int64).reshape(-1, 2), r["crop_seeds"])
              and np.array_equal(wsv.transform(crop, cseeds), r["crop_labels"]),
              f"the {MORPH_CROP}^2 corner ({variant}) on the card == the NumPy oracle")
        route = "" if variant == "segmenting" else (" (tail)" if counts["merge_tail"] else " (shortcut)")
        print(f"[25 morph] {MORPH}^2 golden_morph recipe, {len(mseeds)} seeds, {int((mimg == 255).sum())} NEVER_FILL: "
              f"{variant} transform on the card == the native engine{route}; its {MORPH_CROP}^2 corner == "
              f"oracle_transform; launches { {k: n for k, n in counts.items() if n} }; API wall {m_ms:.1f} ms; "
              f"native {float(r['native_s']):.1f} s, oracle on the corner {float(r['oracle_s']):.1f} s (host, "
              f"in the reference processes); gpu={gpu}")
    x_dev = to_dev(sm_field)
    on_card, pp_ms = timed(lambda: pre_process_jnp(x_dev, MORPH_MAX, device=dev))
    on_cpu = pre_process_jnp(sm_field, MORPH_MAX, device="cpu")
    check(on_card.device.type == dev.type and on_card.dtype == torch.uint8 and torch.equal(on_card.cpu(), on_cpu),
          "pre_process_jnp on the card == on the CPU, bit for bit")
    n_diff = int((on_cpu.numpy() != mimg).sum())
    max_diff = int(np.abs(on_cpu.numpy().astype(int) - mimg).max())
    print(f"[25 morph] pre_process_jnp({MORPH}^2 float64 field, {MORPH_MAX}) on the card == on the CPU; against the "
          f"float64 pre_process {n_diff} pixels differ (at most {max_diff} level); {pp_ms:.2f} ms on the card; "
          f"gpu={gpu}")
    del sm_field, x_dev, on_card, on_cpu
    shutil.rmtree(morph["dir"])


def y0_phase(c) -> dict:
    """Phase 26: the relax kernel's y0 epilogue (``fwd_scan=True``), the
    Hopper counterpart of tools/probe_epilogue.py.  The first relax call at
    4096^2 and 16384^2 (``c.planes``, ``c.planes16``: packed uniform and
    10%-dot planes) held against the twin and its y0 against ``fwd_v_plain``
    of its labels, and timed three ways (plain, statistics, y0); how often
    call 1 certifies at the default steps on the 4096^2 fields
    (``c.fields``); on the fields and steps where it certifies, the fine
    tail from y0 against the tail without it (labels, rounds, one ``fwd_v``
    fewer), the path's launches counted on their own.  Returns the
    ``relax_y0`` row's numbers."""
    import torch

    from rustronomy_watershed_tpu_torch import _ext
    from rustronomy_watershed_tpu_torch.ops import pack, relax
    from rustronomy_watershed_tpu_torch.ops import scan_merge as sm

    s, gpu, err = relax.DEFAULT_STEPS, c.gpu, 0
    out = {}
    for side, (v, key, lab), reps, plain_reps in ((SIDE, c.planes, 20, 5), (BIG, c.planes16, 10, 3)):
        got = relax.relax_block_kernel(v, key, lab, s, fwd_scan=True)
        want = relax.relax_block_plain(v, key, lab, s, fwd_scan=True)
        torch.cuda.synchronize()
        e = max(max_err(got, want), max_err(got[3:], (sm.fwd_v_plain(got[1])[0],)))
        check(e == 0, f"relax y0 kernel == twin (planes, flags, y0) and y0 == fwd_v_plain of its labels at {side}^2")
        err = max(err, e)
        del got, want
        t = {name: c.median_ms(lambda kw=kw: relax.relax_block_kernel(v, key, lab, s, **kw), reps)
             for name, kw in (("plain", {}), ("statistics", {"stats": True}), ("y0", {"fwd_scan": True}))}
        t["twin"] = c.median_ms(lambda: relax.relax_block_plain(v, key, lab, s, fwd_scan=True), plain_reps)
        n = side * side
        t["bound"] = bound(n * (1 + 8 + 8 + 4), n * s * 25)
        out[side] = t
        print(f"[26 y0] {side}^2 first relax call of {s} sweeps: y0 bit-equal to the twin and to fwd_v_plain of its "
              f"labels; plain {t['plain']:.4f} ms, statistics {t['statistics']:.4f} ms, y0 {t['y0']:.4f} ms "
              f"(median of {reps}, CUDA events), twin {t['twin']:.3f} ms, bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]}); gpu={gpu}")

    # How often call 1 certifies, at the default steps and above.
    certified = []
    for label, a in c.fields.items():
        vv, kk, ll, _ = pack.pack_kernel(c.to_dev(a))
        found = []
        for steps in (s, 16, 32, 48):  # past 48 the 128^2 windows' centres shrink below 32^2
            calls, first = [], []

            def seen(src, dst, flags, skipped, calls=calls, first=first):
                calls.append(skipped)
                if not first:
                    first.append(dst[1].clone())

            *_, y0, valid = relax.relax_fixed_point(vv, kk.clone(), ll.clone(), steps=steps, fwd_scan=True,
                                                    on_call=seen)
            e = max_err((y0,), (sm.fwd_v_plain(first[0])[0],))
            check(e == 0 and calls[0] == 0, f"{label} steps={steps}: y0 == fwd_v_plain of call 1's labels")
            err = max(err, e)
            found.append(f"steps {steps}: {len(calls)} calls, y0_valid {valid}")
            if valid:
                certified.append((label, a, steps))
                break
        print(f"[26 y0] {label}: " + "; ".join(found) + f"; gpu={gpu}")
    check(any(lbl.startswith("cone") for lbl, _, _ in certified), "call 1 certifies on the cone lattice")
    n_valid = sum(1 for _, _, st in certified if st == s)
    print(f"[26 y0] y0_valid at the default steps ({s}): {n_valid} of {len(c.fields)} {SIDE}^2 fields")

    # The fwd_scan path where call 1 certifies: relax_packed_planes, then the
    # fine tail from y0, its launches counted on their own; then the tail
    # without y0 on the same labels.
    launches = 0
    for label, a, steps in certified:
        img = c.to_dev(a)
        _ext.reset_launches()
        _, lab_f, _, _, y0, valid = relax.relax_packed_planes(img, None, steps=steps, device=img.device,
                                                              fwd_scan=True)
        y0_kept = y0.clone()  # the tail writes over the y0 it starts from
        got, rounds = sm.component_min_labels(lab_f, y0=y0, y0_valid=valid)
        torch.cuda.synchronize()
        counts = dict(_ext.launches)
        _ext.reset_launches()
        want, rounds_w = sm.component_min_labels(lab_f)
        torch.cuda.synchronize()
        plain_counts = dict(_ext.launches)
        check(valid and counts["relax_y0"] == 1 and counts["relax"] >= 1, f"{label}: the fused path ran the y0 epilogue")
        check(sum(counts[f"{k}_plain"] for k in _ext.KERNELS) == 0, f"{label}: no plain twin on the fused path")
        check(torch.equal(got, want) and rounds == rounds_w, f"{label}: the tail from y0 == the tail without it")
        check(counts["fwd_v"] == plain_counts["fwd_v"] - 1 and counts["bwd_vh"] == plain_counts["bwd_vh"],
              f"{label}: one fwd_v launch fewer from y0")
        launches += counts["relax_y0"]
        # The tail from y0 writes over it: both timings copy y0 first.
        tail_y0 = c.median_ms(lambda: sm.component_min_labels(lab_f, y0=y0_kept.clone(), y0_valid=True), 9)
        tail = c.median_ms(lambda: (y0_kept.clone(), sm.component_min_labels(lab_f)), 9)
        print(f"[26 y0] {label}, steps {steps}: relax_packed_planes(fwd_scan=True) + component_min_labels(y0=) "
              f"== the tail without y0 ({rounds} rounds, fwd_v {counts['fwd_v']} against {plain_counts['fwd_v']}); "
              f"tail {tail_y0:.4f} ms from y0, {tail:.4f} ms without (a copy of y0 in both); launches "
              f"{ {k: n for k, n in counts.items() if n} }; "
              f"gpu={gpu}")
    return {"err": err, "launches": launches, "ms": out[SIDE]["y0"], "plain_ms": out[SIDE]["twin"],
            "bound": out[SIDE]["bound"], "times": out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    from rustronomy_watershed_tpu_torch import _ext
    from rustronomy_watershed_tpu_torch.ops import flood, flood_block, pack, priority, relax
    from rustronomy_watershed_tpu_torch.ops import scan_merge as sm
    from rustronomy_watershed_tpu_torch.ops.histogram import value_histogram
    from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
    from rustronomy_watershed_tpu_torch.ops.pipeline import max_seed_count, watershed_e2e
    from rustronomy_watershed_tpu_torch.ops.seeds import local_extrema_mask, paint_seeds, seed_labels_from_mask
    from rustronomy_watershed_tpu_torch.parity import native
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_fields import cone_lattice, plateau, poisson_u8, seed_lattice, serpentine  # NumPy only

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    print(gpu)
    print(f"[1 device] {name}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _ext.lib()
    print(f"[2 build] nvcc (one process per source) + link + load {time.perf_counter() - t0:.2f} s -> {_ext.library_path()}")
    t0 = time.perf_counter()
    native.lib()
    print(f"[2 build] g++ native engine (parity/oracle.cc) + load {time.perf_counter() - t0:.2f} s -> {native.library_path()}")

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # -- 3: pack kernel against its twin -------------------------------------
    rng = np.random.default_rng(0)
    dots = rng.integers(0, 254, (SIDE, SIDE)).astype(np.uint8)
    dots[rng.random((SIDE, SIDE)) < 0.1] = 255
    fields = {
        "uniform 63x97": rng.integers(0, 256, (63, 97)).astype(np.uint8),
        "uniform 1024^2": rng.integers(0, 256, (1024, 1024)).astype(np.uint8),
        "10% 255-dots 4096^2": dots,
        "plateau 0..3 1024^2": plateau((1024, 1024), 3),
        f"seed lattice {SIDE}^2": seed_lattice((SIDE, SIDE)),
        f"uniform 517x{BIG}": rng.integers(0, 256, (517, BIG)).astype(np.uint8),
    }
    pack_err = 0
    for label, a in fields.items():
        img = to_dev(a)
        route = pack.pack_plan(*a.shape)["route"]
        _ext.reset_launches()
        got = pack.pack_kernel(img)
        check(_ext.launches[f"pack_{route}"] == 1, f"pack took the {route} route on {label}")
        want = pack.pack_plain(img)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err == 0, f"pack kernel == twin on {label}")
        pack_err = max(pack_err, err)
        print(f"[3 pack] {label}: bit-equal to twin (route {route}), {int(got[3])} seeds")
    del img, got, want

    # -- 4: relax kernel against its twin, statistics included ----------------
    img = to_dev(np.random.default_rng(0).integers(0, 254, (SIDE, SIDE)).astype(np.uint8))
    dots_dev = to_dev(dots)
    v, key0, lab0, _ = pack.pack_kernel(img)
    mid_k, mid_l, _ = relax.relax_block_kernel(v, key0, lab0, 8)
    relax_err = 0
    for steps in sorted({1, 8, 16, relax.DEFAULT_STEPS}):
        for state, start in (((key0, lab0), "fresh"), ((mid_k, mid_l), "mid")):
            got = relax.relax_block_kernel(v, *state, steps)
            want = relax.relax_block_plain(v, *state, steps)
            torch.cuda.synchronize()
            err = max_err(got, want)
            check(err == 0, f"relax kernel == {steps} plain sweeps from {start} state")
            relax_err = max(relax_err, err)
            print(f"[4 relax] steps={steps} {start}: planes and flags {got[2].tolist()} bit-equal to twin")

    # The merging epilogue: statistics of the dense and the 10%-dot fields
    # (fresh, mid and at the fixed point) and of a border-seed state.
    vd, kd, ld, _ = pack.pack_kernel(dots_dev)
    fixed = relax.relax_fixed_point(v, key0.clone(), lab0.clone())
    fixed_d = relax.relax_fixed_point(vd, kd.clone(), ld.clone())
    kb, lb = key0.clone(), lab0.clone()
    kb[0, 100], lb[0, 100] = 0, 10**7  # a border seed
    stat_cases = {
        "dense fresh": (v, key0, lab0), "dense mid": (v, mid_k, mid_l),
        "dense fixed point": (v, fixed[0], fixed[1]), "dots fresh": (vd, kd, ld),
        "dots fixed point": (vd, fixed_d[0], fixed_d[1]), "border seed": (v, kb, lb),
    }
    for label, (vv, kk, ll) in stat_cases.items():
        got = relax.relax_block_kernel(vv, kk, ll, relax.DEFAULT_STEPS, stats=True)
        want = relax.relax_block_plain(vv, kk, ll, relax.DEFAULT_STEPS, stats=True)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err == 0, f"relax kernel with statistics == twin on {label}")
        relax_err = max(relax_err, err)
        print(f"[4 relax] stats {label}: flags + statistics {got[2].tolist()} bit-equal to twin")
    check(relax.relax_block_kernel(*stat_cases["border seed"], 8, stats=True)[2][relax.ANY_BORDER].item() == 1,
          "border seed seen by the statistics")

    # Every call of the 4096^2 fixed points, quiet tiles skipped, against the
    # twin's call on the same input planes.
    n_tiles = relax.relax_plan(SIDE, SIDE, relax.DEFAULT_STEPS)["n_tiles"]
    for label, (vv, kk, ll) in (("dense", (v, key0, lab0)), ("10% dots", (vd, kd, ld))):
        for stats in (False, True):
            skips = []

            def held(src, dst, flags, skipped, vv=vv, stats=stats, label=label, skips=skips):
                nonlocal relax_err
                want = relax.relax_block_plain(vv, *src, relax.DEFAULT_STEPS, stats=stats)
                err = max_err((*dst, flags), want)
                check(err == 0, f"relax fixed point call {len(skips)} == twin on {label} (stats={stats})")
                relax_err = max(relax_err, err)
                skips.append(skipped)

            relax.relax_fixed_point(vv, kk.clone(), ll.clone(), stats=stats, on_call=held)
            check(skips[0] == 0, "the first call runs every tile")
            print(f"[4 relax] {label} {SIDE}^2 fixed point (stats={stats}): all {len(skips)} calls bit-equal to the "
                  f"twin (planes and flags); tiles skipped per call {skips} of {n_tiles}")

    # d field pinned at its maximum: the saturated key spreads without
    # carrying into the level field, and the detector fires.
    d_bits = 23
    vs = np.full((24, 128), 255, np.uint8)
    vs[8:16, 8:16] = 5
    ks = np.full((24, 128), 255 << d_bits, np.int32)
    ls = np.zeros((24, 128), np.int32)
    ks[10, 10] = (5 << d_bits) | ((1 << d_bits) - 1)
    ls[10, 10] = 7
    got = relax.relax_block_kernel(to_dev(vs), to_dev(ks), to_dev(ls), 8, d_bits)
    want = relax.relax_block_plain(to_dev(vs), to_dev(ks), to_dev(ls), 8, d_bits)
    check(max_err(got, want) == 0, "saturated relax kernel == twin")
    k2 = got[0].cpu().numpy()
    claimed = k2 != 255 << d_bits
    check(claimed[10, 11] and claimed[12, 12], "saturated key spreads")
    check(((k2[claimed] >> d_bits) == 5).all(), "level field not corrupted")
    check(got[2].tolist()[relax.SAT] == 1, "saturation detector fires")
    print("[4 relax] d-field saturation at d_bits=23: pinned, no carry, sat fires")

    # 7-bit d field: a serpentine plateau saturates it; the public API warns
    # and re-runs on the exact engine.
    h, w, lvl = 41, 38, 5
    serp = np.full((h, w), 255, np.uint8)
    for i, y in enumerate(range(1, h - 1, 2)):
        serp[y, 1 : w - 1] = lvl
        if y + 2 < h - 1:
            serp[y + 1, w - 2 if i % 2 == 0 else 1] = lvl
    saved = relax._D_BITS
    relax._D_BITS = 7
    try:
        ws = TransformBuilder.default().set_device("cuda").build_segmenting()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got7 = ws.transform(serp, [(1, 1)])
    finally:
        relax._D_BITS = saved
    exact = TransformBuilder.default().set_device("cuda").set_backend("relax").build_segmenting()
    check(any("saturation" in str(c.message) for c in caught), "7-bit saturation warns")
    check(np.array_equal(got7, exact.transform(serp, [(1, 1)])), "7-bit fallback == exact engine")
    check((got7[serp == lvl] == 1).all(), "every corridor pixel coloured")
    print("[4 relax] 7-bit d field: saturation warned, fallback equals the exact engine")

    # -- 5: the public API, its launches counted on their own ----------------
    _ext.reset_launches()
    ws = TransformBuilder.default().set_device("cuda").build_segmenting()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        z = np.load(os.path.join(GOLDEN, "golden_morph_v1.npz"))
        cases = [("golden_morph_v1 1024^2", z["img"], z["seeds"], z["segmenting/labels"])]
        z = np.load(os.path.join(GOLDEN, "golden_v1.npz"))
        for f in ("uniform", "poisson", "grf", "nanmasked"):
            cases.append((f"golden_v1 {f} 64^2", z[f"{f}/img"], z[f"{f}/seeds"], z[f"{f}/segmenting/labels"]))
        for label, gimg, gseeds, glabels in cases:
            seeds = ws.find_local_minima(gimg)
            check(np.array_equal(np.asarray(seeds, np.int64).reshape(-1, 2), gseeds), f"seeds of {label}")
            out = ws.transform(gimg, seeds)
            check(out.dtype == np.int32 and np.array_equal(out, glabels), f"segmenting labels of {label}")
            print(f"[5 api] {label}: {len(seeds)} seeds and segmenting labels equal the golden")
    check(not [c for c in caught if "saturation" in str(c.message)], "no saturation warning")
    api = dict(_ext.launches)
    check(api["relax"] > 0, "public API launched the relax kernel")
    check(api["pack_plain"] == 0 and api["relax_plain"] == 0, "no plain twin on the public API path")
    print(f"[5 api] launches {api}")

    # -- 6: the benchmarked path: one watershed_e2e, its launches counted -----
    _ext.reset_launches()
    e2e = watershed_e2e(img, device=dev)
    torch.cuda.synchronize()
    launches = dict(_ext.launches)
    check(launches["pack"] > 0 and launches["relax"] > 0, "e2e launched both kernels")
    check(launches["pack_plain"] == 0 and launches["relax_plain"] == 0, "no plain twin on the main path")
    check(launches["pack_vec"] == 1, "e2e took the 16-byte band route of pack")
    seeds = ws.find_local_minima(img)
    lab_seeds = to_dev(paint_seeds(tuple(img.shape), seeds))
    want, _ = priority.relax_transform(img, lab_seeds)
    check(e2e.shape == img.shape and e2e.dtype == torch.int32, "e2e labels shape and dtype")
    check(torch.equal(e2e, want), "e2e labels == exact engine")
    check(int(e2e.max()) == len(seeds) and int(e2e[0].abs().max()) == 0, "e2e labels in range, border uncoloured")
    print(f"[6 e2e] {SIDE}^2 watershed_e2e equals the exact engine ({len(seeds)} seeds); launches {launches}")
    check(launches["relax_sweeps"] == launches["relax"] * relax.DEFAULT_STEPS, "relax_sweeps = calls that ran x steps")
    check(SIDE * SIDE <= launches["relax_px_run"] <= launches["relax"] * SIDE * SIDE,
          "relax_px_run: the first launch's plane, at most every launch's")
    k = relax._RELAX_BLOCK
    check(launches["relax_launched"] == launches["relax"] + launches["relax_stopped"]
          and k <= launches["relax_stopped"] <= 2 * k - 1 and launches["relax_reads"] == -(-launches["relax"] // k),
          f"relax calls in blocks of {k}: launched = ran + stopped, {k} to {2 * k - 1} stopped on the card, "
          "one flag read a block")
    print(f"[6 e2e] relax over every launch: relax_px_run {launches['relax_px_run']} "
          f"({launches['relax_px_run'] / (SIDE * SIDE):.4f} planes in {launches['relax']} calls that ran), "
          f"relax_sweeps {launches['relax_sweeps']}; {launches['relax_launched']} launches, "
          f"{launches['relax_stopped']} stopped on the card")
    seg_exact = want

    # -- 7: times on the card --------------------------------------------------
    def median_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    def once_ms(fn) -> float:
        """One warm run (everything it needs already built), CUDA events."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    calls = launches["relax"]
    e2e_ms = median_ms(lambda: watershed_e2e(img, device=dev), 9)
    print(
        f"[7 time] {SIDE}^2 e2e {e2e_ms:.3f} ms = {SIDE * SIDE / e2e_ms / 1e3:.1f} Mpix/s, "
        f"{calls} relax calls of {relax.DEFAULT_STEPS} sweeps; gpu={gpu}"
    )
    pack_ms = median_ms(lambda: pack.pack_kernel(img), 20)
    pack_plain_ms = median_ms(lambda: pack.pack_plain(img), 5)
    print(f"[7 time] pack {SIDE}^2: kernel {pack_ms:.3f} ms, plain {pack_plain_ms:.3f} ms; gpu={gpu}")
    s = relax.DEFAULT_STEPS
    relax_ms = median_ms(lambda: relax.relax_block_kernel(v, key0, lab0, s), 20)
    relax_plain_ms = median_ms(lambda: relax.relax_block_plain(v, key0, lab0, s), 5)
    px = SIDE * SIDE
    relax_bound = bound(px * (1 + 8 + 8), px * s * 25)  # ~25 ops per cell and sweep
    print(f"[7 time] relax {SIDE}^2 one call of {s} sweeps: kernel {relax_ms:.3f} ms, plain {relax_plain_ms:.3f} ms, "
          f"bound {relax_bound[0]:.4f} ms ({relax_bound[1]}); gpu={gpu}")
    relax_stats_ms = median_ms(lambda: relax.relax_block_kernel(v, key0, lab0, s, stats=True), 20)
    print(f"[7 time] relax {SIDE}^2 one call of {s} sweeps with statistics: kernel {relax_stats_ms:.3f} ms; gpu={gpu}")
    for label, vv, kk, ll in (("dense", v, key0, lab0), ("10% dots", vd, kd, ld)):
        fp_ms = median_ms(lambda: relax.relax_fixed_point(vv, kk.clone(), ll.clone()), 9)
        print(f"[7 time] relax {SIDE}^2 {label} fixed point (quiet tiles skipped) {fp_ms:.3f} ms; gpu={gpu}")

    # -- 8: the coarse kernels against their twins -----------------------------
    rng8 = np.random.default_rng(8)
    blobs = rng8.integers(0, 254, (1024, 1024)).astype(np.uint8)
    for cy, cx, r in zip(*(rng8.integers(0, 1024, 60), rng8.integers(0, 1024, 60), rng8.integers(4, 40, 60))):
        blobs[max(0, cy - r) : cy + r, max(0, cx - r) : cx + r] = 255
    uni = rng8.integers(0, 254, (1024, 1024)).astype(np.uint8)
    odd = rng8.integers(0, 254, (1023, 1031)).astype(np.uint8)
    odd[rng8.random(odd.shape) < 0.1] = 255
    narrow = rng8.integers(0, 254, (1001, 3)).astype(np.uint8)
    rngt = np.random.default_rng(9)
    tall = rngt.integers(0, 254, TALL).astype(np.uint8)
    tall[rngt.random(TALL) < 0.1] = 255

    def fixed_labels(a, seeds=None):
        lab0_ = None if seeds is None else to_dev(paint_seeds(a.shape, seeds))
        return relax.relax_packed_planes(to_dev(a), lab0_, device=dev)[1]

    border = [(0, 5), (0, 6), (1023, 500), (300, 0), (301, 1023)] + [tuple(p) for p in rng8.integers(1, 1023, (40, 2))]
    narrow_seeds = [(0, 1), (5, 1), (400, 1), (401, 0), (700, 2), (1000, 1)]
    coarse_fields = {
        "10% 255-dots 4096^2": fixed_labels(dots),
        "NaN blobs 1024^2": fixed_labels(blobs),
        "border seeds 1024^2": fixed_labels(uni, border),
        "odd 1023x1031 10% dots": fixed_labels(odd),
        "w=3 1001x3": fixed_labels(narrow, narrow_seeds),
        f"tall {TALL[0]}x{TALL[1]} 10% dots": fixed_labels(tall),
    }
    coarse_fields[f"past the ring {PAST_CAP[0]}x{PAST_CAP[1]}"] = fixed_labels(rngt.integers(0, 254, PAST_CAP).astype(np.uint8))
    coarse_err = {"coarsen": 0, "coarse_round": 0, "coarse_broadcast": 0}

    def coarse_tail_against_twins(label, lab):
        """The coarse tail through the kernels, every round held against the
        twin (plane and change count; the twin runs first, as the round
        writes over its input), and the blocked tail of the main path against
        that loop; returns the rounds and the row route."""
        croute = sm.coarsen_plan(*lab.shape, sm._vec(lab.shape[1], lab))["route"]
        _ext.reset_launches()
        c = sm.coarsen_kernel(lab)
        check(_ext.launches[f"coarsen_{croute}"] == 1, f"coarsen took the {croute} route on {label}")
        err = max_err([c], [sm.coarsen_plain(lab)])
        check(err == 0, f"coarsen kernel == twin on {label}")
        coarse_err["coarsen"] = max(coarse_err["coarsen"], err)
        route = sm.row_plan(*c.shape, _ext.sm_count(dev), coarse=True)["route"]
        scratch, rounds = torch.empty_like(c), 0
        _ext.reset_launches()
        while True:
            want = sm.coarse_round_plain(c)
            got = sm.coarse_round_kernel(c, out=c, scratch=scratch)
            torch.cuda.synchronize()
            err = max_err(got, want)
            check(err == 0, f"coarse round {rounds} kernel == twin on {label}")
            coarse_err["coarse_round"] = max(coarse_err["coarse_round"], err)
            rounds += 1
            if got[1].item() == 0:
                break
            check(rounds < 10000, f"coarse rounds converge on {label}")
        n = _ext.launches
        check(n[f"coarse_round_{route}"] == n["coarse_round_launched"] == n["coarse_round"] == rounds,
              f"the coarse round took the {route} row route on {label}")
        # The blocked tail (the main path's rounds, with the device-side
        # stop) against this round-by-round loop: plane and rounds.
        _ext.reset_launches()
        blocked, blocked_rounds = sm.component_min_coarse(lab, sm._CVAL)
        torch.cuda.synchronize()
        k = sm._TAIL_BLOCK
        check(blocked_rounds == rounds and torch.equal(blocked, sm.coarse_broadcast_kernel(c, lab)),
              f"the blocked coarse tail's labels and rounds == the round-by-round loop's on {label}")
        check(n[f"coarse_round_{route}"] == n["coarse_round_launched"] == n["coarse_round"] + n["coarse_round_skipped"]
              and n["coarse_round"] == rounds and k <= n["coarse_round_skipped"] <= 2 * k - 1
              and n["host_reads"] == -(-rounds // k),
              f"the blocked coarse tail on {label}: {n['coarse_round_launched']} launches, {n['coarse_round']} ran, "
              f"{n['coarse_round_skipped']} stopped on the device, {n['host_reads']} reads")
        _ext.reset_launches()
        broute = sm.broadcast_plan(*lab.shape, sm._vec(lab.shape[1], c, lab))["route"]
        fine = sm.coarse_broadcast_kernel(c, lab)
        check(_ext.launches[f"coarse_broadcast_{broute}"] == _ext.launches["coarse_broadcast"] == 1,
              f"the broadcast took the {broute} route on {label}")
        err = max_err([fine], [sm.coarse_broadcast_plain(c, lab)])
        check(err == 0, f"coarse broadcast kernel == twin on {label}")
        coarse_err["coarse_broadcast"] = max(coarse_err["coarse_broadcast"], err)
        check(torch.equal(fine, sm.component_min_labels_plain(lab)), f"coarse tail == oracle on {label}")
        return rounds, route, croute, broute

    coarse_routes, coarsen_routes, bcast_routes = set(), set(), set()
    for label, lab in coarse_fields.items():
        rounds, route, croute, broute = coarse_tail_against_twins(label, lab)
        coarse_routes.add(route)
        coarsen_routes.add(croute)
        bcast_routes.add(broute)
        print(f"[8 coarse] {label}: coarsen (route {croute}), {rounds} rounds (row route {route}) and broadcast "
              f"(route {broute}) bit-equal to their twins; tail == oracle; the blocked tail's labels and rounds "
              f"== the round-by-round loop's")
    check(coarse_routes == {"ring", "chunked"}, "both row routes of the coarse round ran")
    check(coarsen_routes == {"vec", "cells"}, "both routes of coarsen ran")
    check(bcast_routes == {"vec", "cells"}, "both routes of the broadcast ran")

    # -- 9: the merging public API on the goldens ------------------------------
    _ext.reset_launches()
    wm = TransformBuilder.default().set_device("cuda").build_merging()
    z = np.load(os.path.join(GOLDEN, "golden_morph_v1.npz"))
    mcases = [("golden_morph_v1 1024^2", wm, z["img"], z["seeds"], z["merging/labels"])]
    z = np.load(os.path.join(GOLDEN, "golden_v1.npz"))
    for f in ("uniform", "poisson", "grf", "nanmasked"):
        mcases.append((f"golden_v1 {f} 64^2", wm, z[f"{f}/img"], z[f"{f}/seeds"], z[f"{f}/merging/labels"]))
    wm_edge = TransformBuilder.default().set_device("cuda").enable_edge_correction().build_merging()
    mcases.append(("golden_v1 edge 66^2", wm_edge, z["uniform/img"], z["edge/seeds"], z["edge/merging/labels"]))
    for label, wsm, gimg, gseeds, glabels in mcases:
        out = wsm.transform(gimg, [tuple(p) for p in gseeds])
        check(out.dtype == np.int32 and np.array_equal(out, glabels), f"merging labels of {label}")
        print(f"[9 api] {label}: merging labels equal the golden")
    mapi = dict(_ext.launches)
    check(sum(mapi[f"{k}_plain"] for k in _ext.KERNELS) == 0, "no plain twin on the merging API path")
    print(f"[9 api] launches {mapi}")

    # -- 10: the merging main path: dense (shortcut) and 10% dots (tail) -------
    merge_runs = {}
    for label, field, route, seg in (("dense", img, "merge_shortcut", seg_exact), ("10% dots", dots_dev, "merge_tail", None)):
        if seg is None:
            seeds_f = ws.find_local_minima(field)
            seg, _ = priority.relax_transform(field, to_dev(paint_seeds(tuple(field.shape), seeds_f)))
        _ext.reset_launches()
        got = watershed_e2e(field, merging=True, device=dev)
        torch.cuda.synchronize()
        counts = dict(_ext.launches)
        check(counts[route] == 1, f"merging e2e on {label} took the {route} route")
        check(sum(counts[f"{k}_plain"] for k in _ext.KERNELS) == 0, f"no plain twin on the {label} merging e2e")
        tail = route == "merge_tail"
        for k in ("coarsen", "coarse_round", "coarse_broadcast"):
            check((counts[k] > 0) == tail, f"{k} launched iff the tail ran ({label})")
        check(counts["coarse_round"] + counts["coarse_round_skipped"] == counts["coarse_round_launched"],
              f"the coarse rounds that ran and those that stopped add up to the launches ({label})")
        check(counts["coarsen_vec"] == counts["coarsen"] and counts["pack_vec"] == 1
              and counts["coarse_broadcast_vec"] == counts["coarse_broadcast"],
              f"{label} merging e2e took the vector routes of pack, coarsen and the broadcast")
        check(counts["pack"] == 1 and counts["relax"] > 0, f"{label} merging e2e launched pack and relax")
        check(torch.equal(got, sm.component_min_labels_plain(seg)), f"{label} merging e2e == exact engine + oracle")
        merge_runs[label] = counts
        print(f"[10 merging] {SIDE}^2 {label} watershed_e2e(merging=True) equals the exact engine + oracle; route {route}; launches {counts}")

    # -- 11: transform_batch, 16 x 1024^2 merging cutouts -----------------------
    cut = np.random.default_rng(11).integers(0, 254, (16, 1024, 1024)).astype(np.uint8)
    seeds_b = [wm.find_local_minima(a) for a in cut]
    for label, extra, route in (("clean", [], "merge_shortcut"), ("border seed", [(0, 7)], "merge_tail")):
        sl = [s_ + (extra if i == 3 else []) for i, s_ in enumerate(seeds_b)]
        _ext.reset_launches()
        out = wm.transform_batch(cut, sl)
        counts = dict(_ext.launches)
        check(counts[route] == 1, f"batched merging ({label}) took the {route} route")
        for i in range(len(cut)):
            check(np.array_equal(out[i], wm.transform(cut[i], sl[i])), f"batched merging ({label}) image {i} == transform")
        print(f"[11 batch] 16 x 1024^2 merging transform_batch ({label}) equals per-image transforms; route {route}; launches {counts}")
    batch_ms = median_ms(lambda: wm.transform_batch(cut, seeds_b, device_output=True), 3)
    print(f"[11 batch] 16 x 1024^2 merging transform_batch (clean) {batch_ms:.3f} ms wall of the API call; gpu={gpu}")

    # -- 12: merging times -------------------------------------------------------
    dense_ms = median_ms(lambda: watershed_e2e(img, merging=True, device=dev), 9)
    dots_ms = median_ms(lambda: watershed_e2e(dots_dev, merging=True, device=dev), 9)
    dots_relax_ms = median_ms(lambda: relax.relax_packed_planes(dots_dev, None, device=dev, stats=True), 9)
    lab_d = coarse_fields["10% 255-dots 4096^2"]
    tail_rounds = sm.component_min_coarse(lab_d, sm._CVAL)[1]
    cells = (SIDE // 2) * SIDE
    tail_ms = median_ms(lambda: sm.component_min_coarse(lab_d, sm._CVAL), 9)
    print(f"[12 time] {SIDE}^2 merging e2e: dense {dense_ms:.3f} ms ({SIDE * SIDE / dense_ms / 1e3:.1f} Mpix/s, "
          f"relax calls {merge_runs['dense']['relax']}, shortcut); 10% dots {dots_ms:.3f} ms "
          f"({SIDE * SIDE / dots_ms / 1e3:.1f} Mpix/s, relax calls {merge_runs['10% dots']['relax']}); gpu={gpu}")
    print(f"[12 time] 10% dots split: pack + relax with statistics {dots_relax_ms:.3f} ms, coarse tail {tail_ms:.3f} ms "
          f"in {tail_rounds} rounds; gpu={gpu}")
    c0 = sm.coarsen_kernel(lab_d)
    c_fin = sm.coarsen_kernel(lab_d)
    scratch = torch.empty_like(c_fin)
    while sm.coarse_round_kernel(c_fin, out=c_fin, scratch=scratch)[1].item():
        pass
    coarsen_ms = median_ms(lambda: sm.coarsen_kernel(lab_d), 20)
    coarsen_plain_ms = median_ms(lambda: sm.coarsen_plain(lab_d), 5)
    round_ms = median_ms(lambda: sm.coarse_round_kernel(c0, scratch=scratch), 20)
    round_plain_ms = median_ms(lambda: sm.coarse_round_plain(c0), 5)
    bcast_ms = median_ms(lambda: sm.coarse_broadcast_kernel(c_fin, lab_d), 20)
    bcast_plain_ms = median_ms(lambda: sm.coarse_broadcast_plain(c_fin, lab_d), 5)
    round_bound = bound(2 * cells * 4, 2 * cells * 12)  # plane in, plane out; two passes of scans
    print(f"[12 time] coarsen {SIDE}^2: kernel {coarsen_ms:.3f} ms, plain {coarsen_plain_ms:.3f} ms; "
          f"first coarse round: kernel {round_ms:.3f} ms, plain {round_plain_ms:.3f} ms, bound {round_bound[0]:.4f} ms "
          f"({round_bound[1]}); broadcast: kernel {bcast_ms:.3f} ms, plain {bcast_plain_ms:.3f} ms; gpu={gpu}")
    round_in, round_scratch = c0, scratch  # for the per-launch split (phase 19: one profiler session a process)

    # -- 13: the flood kernel against its twin, both flags included ----------
    img_np, odd_dev = img.cpu().numpy(), to_dev(odd)
    flood_cases = [
        (f"uniform {SIDE}^2", img, (0, 60, 200)),
        (f"10% 255-dots {SIDE}^2", dots_dev, (0, 60, 200)),
        ("plateau 0..3 1024^2", to_dev(fields["plateau 0..3 1024^2"]), (0, 1, 3)),
        ("odd 1023x1031 10% dots", odd_dev, (0, 100)),
        ("uniform 63x97", to_dev(fields["uniform 63x97"]), (0, 120, 254)),
    ]
    flood_err, fs = 0, flood_block.DEFAULT_STEPS
    for label, field, levels in flood_cases:
        fimg = flood_block.flood_image(field)
        fresh = seed_labels_from_mask(local_extrema_mask(field))
        for lvl in levels:
            # A fresh state (seeds only) and a mid-level one (two twin calls in).
            mid = flood_block.flood_block_plain(fimg, flood_block.flood_block_plain(fimg, fresh, lvl, fs)[0], lvl, fs)[0]
            for start, state in (("fresh", fresh), ("mid", mid)):
                got = flood_block.flood_block_kernel(fimg, state, lvl, fs)
                want = flood_block.flood_block_plain(fimg, state, lvl, fs)
                torch.cuda.synchronize()
                err = max_err(got, want)
                check(err == 0, f"flood kernel == twin on {label} at level {lvl} from a {start} state")
                flood_err = max(flood_err, err)
                print(f"[13 flood] {label} level {lvl} {start}: plane and flags [painted, not converged] "
                      f"{got[1].tolist()} bit-equal to twin")
    fimg = flood_block.flood_image(img)
    fresh = seed_labels_from_mask(local_extrema_mask(img))
    fixed60, _, painted = flood_block.flood_fixed_point_block(fimg, fresh.clone(), 60)
    want, want_painted = flood.flood_fixed_point(img, fresh, 60)
    check(torch.equal(fixed60, want) and painted == want_painted, "flood kernel fixed point == plain fixed point")
    print(f"[13 flood] {SIDE}^2 level-60 fixed point through the kernel equals the plain sweeps (painted {painted})")

    def flood_level_sweep(field, lab_, on_call):
        """The flood-kernel level sweep of ops/level_driver.py (segmenting)
        written out, so that every call is seen: ``on_call(lvl, first, src,
        dst, flags, skipped)``.  Overwrites ``lab_``; returns the labels."""
        fimg_ = flood_block.flood_image(field)
        scratch_, tiles_ = lab_.clone(), flood_block.flood_tiles(fimg_)
        vhist = value_histogram(field).tolist()
        for lvl_ in range(255):
            if lvl_ and not vhist[lvl_]:
                continue
            k = [0]

            def seen(*call, lvl_=lvl_, k=k):
                on_call(lvl_, k[0] == 0, *call)
                k[0] += 1

            lab_, scratch_, _ = flood_block.flood_fixed_point_block(fimg_, lab_, lvl_, scratch=scratch_, tiles=tiles_,
                                                                    on_call=seen)
        return lab_

    # Every call of the uniform and Poisson(30) level sweeps (segmenting,
    # quiet tiles skipped) against the twin's call on the same input.
    poisson_np = poisson_u8((SIDE, SIDE))
    n_flood_tiles = flood_block.flood_plan(SIDE, SIDE, fs)["n_tiles"]
    for label, field in ((f"uniform {SIDE}^2", img), (f"Poisson(30) {SIDE}^2", to_dev(poisson_np))):
        fimg_s, seeds_s = flood_block.flood_image(field), seed_labels_from_mask(local_extrema_mask(field))
        skips, firsts = [], []

        def held(lvl_, first, src, dst, flags, skipped, fimg_s=fimg_s, label=label, skips=skips, firsts=firsts):
            nonlocal flood_err
            err = max_err((dst, flags), flood_block.flood_block_plain(fimg_s, src, lvl_, fs))
            check(err == 0, f"level-sweep flood call {len(skips)} (level {lvl_}) == twin on {label}")
            flood_err = max(flood_err, err)
            skips.append(skipped)
            firsts.append(first)

        got_ls = flood_level_sweep(field, seeds_s.clone(), held)
        want_ls = run_levels_impl(field, seeds_s, max_water_level=254, backend="flood", device=dev)
        check(torch.equal(got_ls, want_ls), f"the written-out level sweep == the level driver's on {label}")
        check(sum(skips) > 0, f"the {label} level sweep skipped tiles")
        print(f"[13 flood] {label} level sweep (segmenting): all {len(skips)} calls bit-equal to the twin (plane and "
              f"flags); tiles skipped of {n_flood_tiles}, first calls of a level: "
              f"{[n for n, f in zip(skips, firsts) if f]}; later calls: {[n for n, f in zip(skips, firsts) if not f]}")
    del got_ls, want_ls, fimg_s, seeds_s

    # -- 14: the level-sweep engine (backend 'pallas') at full width -----------
    def build(variant, backend):
        return getattr(TransformBuilder.default().set_device("cuda").set_backend(backend), f"build_{variant}")()

    level_runs = {}
    both = ("segmenting", "merging")
    for label, field_np, variants in ((f"uniform {SIDE}^2", img_np, both), (f"10% 255-dots {SIDE}^2", dots, both),
                                      (f"Poisson(30) {SIDE}^2", poisson_np, ("segmenting",))):
        seeds_f = ws.find_local_minima(field_np)
        for variant in variants:
            want = build(variant, "auto").transform(field_np, seeds_f, device_output=True)
            _ext.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = build(variant, "pallas").transform(field_np, seeds_f, device_output=True)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = dict(_ext.launches)
            check(torch.equal(got, want), f"level-sweep {variant} labels == packed engine on {label}")
            check(counts["flood"] > 0 and counts["flood_plain"] == 0, f"level sweep launched the flood kernel ({label})")
            check(sum(counts[f"{k}_plain"] for k in _ext.KERNELS) == 0, f"no plain twin on the level sweep ({label})")
            check(counts["flood_tiles"] == counts["flood"], f"every level-sweep flood call ran with tile state ({label})")
            check(counts["flood_tiles_skipped"] > 0 or label.startswith("10%"), f"the level sweep skipped tiles ({label})")
            level_runs[(label, variant)] = counts
            print(f"[14 level sweep] {label} {variant}: labels equal the packed engine; {counts['flood']} flood calls "
                  f"skipping the sweeps of {counts['flood_tiles_skipped']} of {counts['flood'] * n_flood_tiles} tiles "
                  f"({counts['flood_tiles_copied']} of them copied), "
                  f"{counts['merge_round']} merge rounds; API wall {wall:.1f} ms; gpu={gpu}")
    lab_u = to_dev(paint_seeds(img_np.shape, ws.find_local_minima(img_np)))
    n_seeds = int(lab_u.max())
    for variant in ("segmenting", "merging"):
        lvl_ms = once_ms(lambda: run_levels_impl(
            img, lab_u, n_labels=n_seeds, max_water_level=254, merging=variant == "merging",
            backend="flood", device=dev))
        print(f"[14 time] {SIDE}^2 level-sweep {variant} e2e (driver, seeds painted) {lvl_ms:.1f} ms "
              f"= {SIDE * SIDE / lvl_ms / 1e3:.2f} Mpix/s; gpu={gpu}")

    # -- 15: the per-level API at 1024^2 on golden_morph_v1 --------------------
    zc = np.load(os.path.join(GOLDEN, "golden_morph_v1.npz"))
    pimg = zc["img"]
    pseeds = ws.find_local_minima(pimg)
    plot_root = os.path.join(HERE, "build", "smoke_plots")

    def digest(ctx):
        return (ctx.water_level, hashlib.sha1(ctx.colours.tobytes()).hexdigest(),
                hashlib.sha1(ctx.image.tobytes()).hexdigest(), ctx.seeds[-1])

    for variant in ("segmenting", "merging"):
        auto, sweep = build(variant, "auto"), build(variant, "pallas")
        walls, results = {}, {}
        for route, wsx in (("auto", auto), ("pallas", sweep)):
            t0 = time.perf_counter()
            results[(route, "list")] = wsx.transform_to_list(pimg, pseeds, counts_length=len(pseeds) + 1)
            walls[(route, "to_list")] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            results[(route, "history")] = wsx.transform_history(pimg, pseeds)
            walls[(route, "history")] = (time.perf_counter() - t0) * 1e3
        for what in ("list", "history"):
            a, b = results[("auto", what)], results[("pallas", what)]
            check(len(a) == len(b) == 255 and all(x[0] == y[0] and np.array_equal(x[1], y[1]) for x, y in zip(a, b)),
                  f"{variant} transform_{what} on 'auto' == on 'pallas'")
        if variant == "merging":
            check(np.array_equal(np.stack([r for _, r in results[("auto", "list")]]), zc["merging/sizes"]),
                  "merging transform_to_list == golden sizes")
        results.clear()
        replay = getattr(TransformBuilder.default().set_device("cuda").set_wlvl_hook(digest), f"build_{variant}")()
        hook_replay = replay.transform_with_hook(pimg, pseeds)
        host = getattr(TransformBuilder.default().set_device("cuda").set_wlvl_hook(digest).enable_progress(),
                       f"build_{variant}")()
        bar = io.StringIO()
        with contextlib.redirect_stderr(bar):
            hook_host = host.transform_with_hook(pimg, pseeds)
        check(hook_replay == hook_host and len(hook_host) == 255, f"{variant} hook views: replay == host loop")
        check("water level 254/254" in bar.getvalue(), f"{variant} progress bar reached the last level")
        folder = os.path.join(plot_root, variant)
        shutil.rmtree(folder, ignore_errors=True)
        os.makedirs(folder)
        plotter = getattr(TransformBuilder.default().set_device("cuda").set_plot_folder(folder), f"build_{variant}")()
        check(np.array_equal(plotter.transform(pimg, pseeds), auto.transform(pimg, pseeds)), f"{variant} plotted transform")
        files = os.listdir(folder)
        check(sorted(files) == sorted(f"ws_lvl{i}.png" for i in range(255)), f"{variant} plots ws_lvl0..254.png written")
        print(f"[15 per-level] golden_morph_v1 1024^2 {variant}: to_list and history equal on 'auto' and 'pallas'; "
              f"hook replay == progress host loop; {len(files)} plots")
        print(f"[15 time] 1024^2 {variant} wall ms: to_list auto {walls[('auto', 'to_list')]:.1f}, "
              f"pallas {walls[('pallas', 'to_list')]:.1f}; history auto {walls[('auto', 'history')]:.1f}, "
              f"pallas {walls[('pallas', 'history')]:.1f}; gpu={gpu}")

    # -- 16: flood kernel times --------------------------------------------------
    flood_ms = median_ms(lambda: flood_block.flood_block_kernel(fimg, fresh, 200, fs), 20)
    flood_plain_ms = median_ms(lambda: flood_block.flood_block_plain(fimg, fresh, 200, fs), 5)
    quiet_ms = median_ms(lambda: flood_block.flood_block_kernel(fimg, fixed60, 60, fs), 20)
    # A later call after one that changed nothing: every block returns at once.
    skip_tiles = flood_block.FloodTiles(flood_block.flood_plan(SIDE, SIDE, fs), dev)
    skip_out = torch.empty_like(fixed60)

    def skip_call():
        return flood_block.flood_block_kernel(fimg, fixed60, 60, fs, out=skip_out, tiles=skip_tiles)

    skip_ms = median_ms(skip_call, 20)
    check(skip_tiles.flags.tolist() == [0, 0, n_flood_tiles, 0], "the quiet call skipped every tile, copying none")
    print(f"[16 time] flood {SIDE}^2 one call of {fs} sweeps at level 200 from the seeds: kernel {flood_ms:.4f} ms, "
          f"plain {flood_plain_ms:.3f} ms; a quiet call (the level-60 fixed point) with every tile run {quiet_ms:.4f} ms, "
          f"with every tile skipped {skip_ms:.4f} ms (CUDA events; device times in phase 19); gpu={gpu}")

    # -- 17: the fine scan tail's kernels against their twins -----------------
    def hold(errs, kname, got, want, what):
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err == 0, f"{kname} kernel == twin on {what}")
        errs[kname] = max(errs[kname], err)
        return got

    def rounds_against_twins(x, passes, errs, label, window=None):
        """A two-pass tail (the package's own round loop) through the
        kernels, every pass held against its twin on the same input (planes
        and flags; the twin runs first, as the kernel may write over its
        input); returns the fixed point and the rounds."""
        (fname, fk, fp), (bname, bk, bp) = passes

        def fwd(y, out=None):
            want = fp(y)
            return hold(errs, fname, fk(y, out=out), want, f"{label}, pass 1")

        def bwd(y, k, out, scratch):
            hw = () if window is None else (window(k),)
            want = bp(y, *hw)
            return hold(errs, bname, bk(y, *hw, out=out, scratch=scratch), want, f"{label}, round {k}")

        return sm._two_pass_rounds(x, fwd, bwd)

    rng17 = np.random.default_rng(17)

    def sparse_labels(shape):
        return to_dev(np.where(rng17.random(shape) < 0.3, 0, rng17.integers(1, 1 << 26, shape)).astype(np.int32))

    fine_passes = (("fwd_v", sm.fwd_v_kernel, sm.fwd_v_plain), ("bwd_vh", sm.bwd_vh_kernel, sm.bwd_vh_plain))
    lab_d = coarse_fields["10% 255-dots 4096^2"]
    fine_fields = {
        f"10% 255-dots {SIDE}^2 labels": lab_d,
        "odd 1023x1031 10% dots": coarse_fields["odd 1023x1031 10% dots"],
        "uniform 63x97": fixed_labels(fields["uniform 63x97"]),
        f"{SIDE}x1 labels": sparse_labels((SIDE, 1)),
        f"{SIDE}x2 labels": sparse_labels((SIDE, 2)),
        "serpentine 48^2": to_dev(serpentine()),
        f"tall {TALL[0]}x{TALL[1]} 10% dots": coarse_fields[f"tall {TALL[0]}x{TALL[1]} 10% dots"],
        f"past the ring {PAST_CAP[0]}x{PAST_CAP[1]} labels": sparse_labels(PAST_CAP),
    }
    fine_err = {"fwd_v": 0, "bwd_vh": 0}
    for label, lab in fine_fields.items():
        _ext.reset_launches()
        out, rounds = rounds_against_twins(lab, fine_passes, fine_err, label)
        route = "chunked" if lab.shape[1] > sm._ROW_CAP else "ring"
        check(_ext.launches[f"bwd_vh_{route}"] == _ext.launches["bwd_vh"] == rounds, f"bwd_vh took the {route} row route on {label}")
        check(torch.equal(out, sm.component_min_labels_plain(lab)), f"fine tail == oracle on {label}")
        print(f"[17 fine] {label}: fwd_v and bwd_vh bit-equal to their twins (planes and flags) "
              f"over all {rounds} rounds, row route {route}; tail == oracle")

    # -- 18: the legacy coarse rounds (RWT_COARSE_MULTI=0) against their twins -
    coarse_passes = (("cfwd_v", sm.cfwd_v_kernel, sm.cfwd_v_plain), ("cbwd_vh", sm.cbwd_vh_kernel, sm.cbwd_vh_plain))
    legacy_err = {"cfwd_v": 0, "cbwd_vh": 0}
    for label, lab in coarse_fields.items():
        windows = [("legacy windows", sm._legacy_window)]
        if lab is lab_d:
            windows.append(("full width", lambda k: None))
        if label.startswith("odd"):  # RWT_COARSE_HWIN=2 and =300 on every round
            windows += [("window 2", lambda k: 2), ("window 300", lambda k: 300)]
        route = "chunked" if lab.shape[1] > sm._ROW_CAP else "ring"
        for sched, window in windows:
            _ext.reset_launches()
            cfin, rounds = rounds_against_twins(sm.coarsen_kernel(lab), coarse_passes, legacy_err, f"{label} ({sched})", window)
            check(_ext.launches[f"cbwd_vh_{route}"] == _ext.launches["cbwd_vh"] == rounds,
                  f"cbwd_vh took the {route} row route on {label} ({sched})")
            check(torch.equal(sm.coarse_broadcast_kernel(cfin, lab), sm.component_min_labels_plain(lab)),
                  f"legacy coarse tail == oracle on {label} ({sched})")
            print(f"[18 legacy] {label} ({sched}): cfwd_v and cbwd_vh bit-equal to their twins over all "
                  f"{rounds} rounds (row route {route}); tail == oracle")
    # The legacy schedule's own path: the merging transform with the switch off.
    default_d = watershed_e2e(dots_dev, merging=True, device=dev)
    sm._COARSE_MULTI = False
    try:
        _ext.reset_launches()
        legacy_d = watershed_e2e(dots_dev, merging=True, device=dev)
        torch.cuda.synchronize()
        legacy_counts = dict(_ext.launches)
        legacy_ms = median_ms(lambda: watershed_e2e(dots_dev, merging=True, device=dev), 5)
    finally:
        sm._COARSE_MULTI = True
    check(legacy_counts["cfwd_v"] > 0 and legacy_counts["cbwd_vh"] > 0 and legacy_counts["coarse_round"] == 0,
          "the legacy merging e2e launched cfwd_v and cbwd_vh, no coarse_round")
    check(legacy_counts["cbwd_vh_ring"] == legacy_counts["cbwd_vh"], "the legacy merging e2e's cbwd_vh took the ring")
    check(sum(legacy_counts[f"{k}_plain"] for k in _ext.KERNELS) == 0, "no plain twin on the legacy merging e2e")
    check(torch.equal(legacy_d, default_d), "legacy schedule == default coarse tail")
    print(f"[18 legacy] {SIDE}^2 10% dots watershed_e2e(merging=True) with RWT_COARSE_MULTI=0 equals the default: "
          f"{legacy_counts['cbwd_vh']} legacy rounds against {merge_runs['10% dots']['coarse_round']} default rounds; "
          f"{legacy_ms:.3f} ms against {dots_ms:.3f} ms (ratio {legacy_ms / dots_ms:.2f}); launches {legacy_counts}; "
          f"gpu={gpu}")

    y_d = sm.fwd_v_kernel(lab_d)[0]
    c_d = sm.coarsen_kernel(lab_d)
    cy_d = sm.cfwd_v_kernel(c_d)[0]
    scratch_f, scratch_c = torch.empty_like(y_d), torch.empty_like(c_d)
    pass_ms = {
        "fwd_v": (median_ms(lambda: sm.fwd_v_kernel(lab_d), 20), median_ms(lambda: sm.fwd_v_plain(lab_d), 5)),
        "bwd_vh": (median_ms(lambda: sm.bwd_vh_kernel(y_d, scratch=scratch_f), 20), median_ms(lambda: sm.bwd_vh_plain(y_d), 5)),
        "cfwd_v": (median_ms(lambda: sm.cfwd_v_kernel(c_d), 20), median_ms(lambda: sm.cfwd_v_plain(c_d), 5)),
        "cbwd_vh": (median_ms(lambda: sm.cbwd_vh_kernel(cy_d, sm._COARSE_HWIN, scratch=scratch_c), 20),
                    median_ms(lambda: sm.cbwd_vh_plain(cy_d, sm._COARSE_HWIN), 5)),
        "cbwd_vh full width": (median_ms(lambda: sm.cbwd_vh_kernel(cy_d, scratch=scratch_c), 20),
                               median_ms(lambda: sm.cbwd_vh_plain(cy_d), 5)),
    }
    pass_bounds = {  # plane in, plane out; ~6 ops per cell for a scan, ~25 for pass 2
        "fwd_v": bound(px * 8, px * 6), "bwd_vh": bound(px * 8, px * 25),
        "cfwd_v": bound(cells * 8, cells * 6), "cbwd_vh": bound(cells * 8, cells * 25),
        "cbwd_vh full width": bound(cells * 8, cells * 25),
    }
    for kname, (ms, plain_ms) in pass_ms.items():
        b_ms, b_by = pass_bounds[kname]
        print(f"[18 time] {kname} {SIDE}^2 dot labels: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}); gpu={gpu}")
    del y_d, c_d, cy_d, scratch_f, scratch_c

    # -- 19: 16384^2 -----------------------------------------------------------
    rng19 = np.random.default_rng(0)  # drawn as phases 3 and 4 draw the 4096^2 fields
    dense16 = rng19.integers(0, 254, (BIG, BIG)).astype(np.uint8)
    dots16 = dense16.copy()
    dots16[rng19.random((BIG, BIG)) < 0.1] = 255
    big = {"dense": to_dev(dense16), "10% dots": to_dev(dots16)}
    del dense16, dots16
    check(max_seed_count((BIG, BIG)) >= 1 << 24, f"the {BIG}^2 label bound fails the coarse gate")
    t0 = time.perf_counter()
    exact16 = {k: priority.relax_transform(f, seed_labels_from_mask(local_extrema_mask(f)))[0] for k, f in big.items()}
    torch.cuda.synchronize()
    print(f"[19 {BIG}^2] exact engine on both fields {time.perf_counter() - t0:.1f} s")
    big_runs = {}
    for label, field in big.items():
        for merging in (False, True):
            variant = "merging" if merging else "segmenting"
            _ext.reset_launches()
            got = watershed_e2e(field, merging=merging, device=dev)
            torch.cuda.synchronize()
            counts = dict(_ext.launches)
            want = sm.component_min_labels_plain(exact16[label]) if merging else exact16[label]
            check(torch.equal(got, want), f"{BIG}^2 {label} {variant} e2e == exact engine" + (" + oracle" if merging else ""))
            check(sum(counts[f"{k}_plain"] for k in _ext.KERNELS) == 0, f"no plain twin on the {BIG}^2 {label} {variant} e2e")
            check(counts["pack"] == 1 and counts["relax"] > 0, f"{BIG}^2 {label} {variant} e2e launched pack and relax")
            check(counts["pack_vec"] == 1, f"{BIG}^2 {label} {variant} e2e took the 16-byte band route of pack")
            if merging:
                tail = label == "10% dots"
                check(counts["merge_tail" if tail else "merge_shortcut"] == 1, f"{BIG}^2 {label} merging route")
                check((counts["fwd_v"] > 0 and counts["bwd_vh"] > 0) == tail, f"{BIG}^2 {label}: the fine tail ran iff the tail did")
                check(counts["bwd_vh_ring"] == counts["bwd_vh"] and counts["bwd_vh_chunked"] == 0,
                      f"{BIG}^2 {label}: bwd_vh took the ring row route")
                check(counts["coarsen"] == counts["coarse_round"] == counts["cbwd_vh"] == 0, f"{BIG}^2 {label}: no coarse kernel")
                if tail:
                    merged_e2e16 = got  # equal to the exact engine + oracle
            del got, want
            big_runs[(label, variant)] = counts
            print(f"[19 {BIG}^2] {label} watershed_e2e({variant}) equals the exact engine"
                  + (" + oracle" if merging else "") + f"; launches {counts}")
    dots16_dev, lab16 = big["10% dots"], exact16["10% dots"]

    # The fine tail at the main path's shape: every pass against its twin.
    merged16, tail_rounds16 = rounds_against_twins(lab16, fine_passes, fine_err, f"{BIG}^2 10% dots labels")
    check(tail_rounds16 == big_runs[("10% dots", "merging")]["bwd_vh"], f"{BIG}^2 fine tail rounds == the e2e's")
    check(torch.equal(merged16, merged_e2e16), f"{BIG}^2 fine tail == exact engine + oracle")
    print(f"[19 {BIG}^2] 10% dots labels: fwd_v and bwd_vh bit-equal to their twins (planes and flags) "
          f"over all {tail_rounds16} rounds; tail == oracle")
    del merged16, merged_e2e16

    # The relax kernel at width 16384 against its twin, one call each way.
    v16, key16, lab16_0, _ = pack.pack_kernel(dots16_dev)
    relax2d_err = 0
    for stats in (False, True):
        got = relax.relax_block_kernel(v16, key16, lab16_0, s, stats=stats)
        want = relax.relax_block_plain(v16, key16, lab16_0, s, stats=stats)
        torch.cuda.synchronize()
        relax2d_err = max(relax2d_err, max_err(got, want))
        check(relax2d_err == 0, f"relax kernel == twin at {BIG}^2 (stats={stats})")
        del got, want
    print(f"[19 {BIG}^2] relax kernel at width {BIG}: one call of {s} sweeps, planes and flags bit-equal to the twin, "
          "with and without statistics")

    # 16384-long rows with labels below 2**24: the coarse tail.
    rngw = np.random.default_rng(19)
    wide = rngw.integers(0, 254, WIDE).astype(np.uint8)
    wide[rngw.random(WIDE) < 0.1] = 255
    wide_dev = to_dev(wide)
    _ext.reset_launches()
    got = watershed_e2e(wide_dev, merging=True, device=dev)
    torch.cuda.synchronize()
    wide_counts = dict(_ext.launches)
    seg_w, _ = priority.relax_transform(wide_dev, seed_labels_from_mask(local_extrema_mask(wide_dev)))
    check(torch.equal(got, sm.component_min_labels_plain(seg_w)), f"{WIDE[0]}x{WIDE[1]} merging e2e == exact engine + oracle")
    check(wide_counts["merge_tail"] == 1 and wide_counts["coarse_round"] > 0 and wide_counts["fwd_v"] == 0,
          f"{WIDE[0]}x{WIDE[1]} merging e2e ran the coarse tail")
    check(sum(wide_counts[f"{k}_plain"] for k in _ext.KERNELS) == 0, f"no plain twin on the {WIDE[0]}x{WIDE[1]} e2e")
    print(f"[19 wide] {WIDE[0]}x{WIDE[1]} 10% dots watershed_e2e(merging=True) equals the exact engine + oracle "
          f"on the coarse tail; launches {wide_counts}")
    rounds_w, route_w, croute_w, broute_w = coarse_tail_against_twins(f"{WIDE[0]}x{WIDE[1]} 10% dots", fixed_labels(wide))
    check(rounds_w == wide_counts["coarse_round"] and route_w == "ring" and croute_w == broute_w == "vec",
          f"{WIDE[0]}x{WIDE[1]}: the e2e's coarse tail")
    print(f"[19 wide] {WIDE[0]}x{WIDE[1]} 10% dots: coarsen (route {croute_w}) and all {rounds_w} coarse rounds (row "
          f"route {route_w}) bit-equal to the twin, planes and change counts")
    del got, seg_w, wide_dev

    # The public API on a two-column field: the gate fails through w < 3.
    rnga = np.random.default_rng(20)
    thin = rnga.integers(0, 254, (SIDE, 2)).astype(np.uint8)
    thin[rnga.random(thin.shape) < 0.1] = 255
    thin_seeds = sorted({(int(r), int(c)) for r, c in zip(rnga.integers(0, SIDE, 600), rnga.integers(0, 2, 600))})
    _ext.reset_launches()
    got = wm.transform(thin, thin_seeds)
    thin_counts = dict(_ext.launches)
    want = TransformBuilder.default().set_device("cpu").build_merging().transform(thin, thin_seeds)
    check(np.array_equal(got, want) and (got != 0).any(), f"{SIDE}x2 merging transform == the plain route")
    check(thin_counts["merge_tail"] == 1 and thin_counts["fwd_v"] > 0 and thin_counts["bwd_vh"] > 0
          and thin_counts["coarsen"] == 0, f"{SIDE}x2 merging transform ran the fine kernels")
    check(sum(thin_counts[f"{k}_plain"] for k in _ext.KERNELS) == 0, f"no plain twin on the {SIDE}x2 transform")
    print(f"[19 api] {SIDE}x2 build_merging().transform ({len(thin_seeds)} seeds) equals the plain route on the fine "
          f"kernels; launches {thin_counts}")

    # Times at 16384^2.
    for label, field in big.items():
        for merging in (False, True):
            variant = "merging" if merging else "segmenting"
            reps = 3 if (merging and label == "10% dots") else 5
            ms = median_ms(lambda: watershed_e2e(field, merging=merging, device=dev), reps)
            print(f"[19 time] {BIG}^2 {label} {variant} e2e {ms:.3f} ms = {BIG * BIG / ms / 1e3:.1f} Mpix/s, "
                  f"relax calls {big_runs[(label, variant)]['relax']}; gpu={gpu}")
    tail_ms16 = once_ms(lambda: sm.component_min_fine(lab16))
    print(f"[19 time] {BIG}^2 10% dots fine tail {tail_ms16:.3f} ms in {tail_rounds16} rounds "
          f"({tail_ms16 / tail_rounds16:.3f} ms per round); gpu={gpu}")
    y16 = sm.fwd_v_kernel(lab16)[0]
    scratch16 = torch.empty_like(y16)
    leg_in = sm.cfwd_v_kernel(round_in)[0]  # a legacy round's pass-2 input at 4096^2
    leg_scratch = torch.empty_like(leg_in)
    big_ms = {
        "relax2d": (median_ms(lambda: relax.relax_block_kernel(v16, key16, lab16_0, s), 10),
                    median_ms(lambda: relax.relax_block_plain(v16, key16, lab16_0, s), 3)),
        "fwd_v": (median_ms(lambda: sm.fwd_v_kernel(lab16), 10), median_ms(lambda: sm.fwd_v_plain(lab16), 3)),
        "bwd_vh": (median_ms(lambda: sm.bwd_vh_kernel(y16, scratch=scratch16), 10), median_ms(lambda: sm.bwd_vh_plain(y16), 3)),
    }
    big_ms["pack"] = (median_ms(lambda: pack.pack_kernel(dots16_dev), 10), median_ms(lambda: pack.pack_plain(dots16_dev), 3))
    px16 = BIG * BIG
    big_bounds = {
        "relax2d": bound(px16 * (1 + 8 + 8), px16 * s * 25),
        "fwd_v": bound(px16 * 8, px16 * 6), "bwd_vh": bound(px16 * 8, px16 * 25),
        "pack": bound(px16 * (1 + 1 + 4 + 4), px16 * 20),
    }
    for kname, (ms, plain_ms) in big_ms.items():
        b_ms, b_by = big_bounds[kname]
        print(f"[19 time] {kname} {BIG}^2: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); gpu={gpu}")
    # bwd_vh's two launches apart (the column scan and the ring row kernel),
    # the 4096^2 coarse round's three (the v-pass's two column scans and
    # the h-pass), and the device time of pack (4096^2 and 16384^2) and of
    # coarsen (4096^2), so that the host's launch work is apart from the
    # kernels' time, in one profiler session: a second session in the same
    # process saw no device activity on the H100 host.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            sm.bwd_vh_kernel(y16, scratch=scratch16)
        for _ in range(10):
            sm.coarse_round_kernel(round_in, scratch=round_scratch)
        for h_window in (sm._COARSE_HWIN, None):  # a legacy round: windowed, then full width
            for _ in range(10):
                sm.cbwd_vh_kernel(leg_in, h_window, scratch=leg_scratch)
        for _ in range(10):
            sm.cfwd_v_kernel(round_in)
        for _ in range(10):
            pack.pack_kernel(img)
            sm.coarsen_kernel(lab_d)
        torch.cuda.synchronize()
        for _ in range(5):
            pack.pack_kernel(dots16_dev)
        torch.cuda.synchronize()
        for _ in range(10):
            flood_block.flood_block_kernel(fimg, fresh, 200, fs)
            sm.coarse_broadcast_kernel(c_fin, lab_d)
        torch.cuda.synchronize()
        for _ in range(10):
            skip_call()
        torch.cuda.synchronize()
        for planes, reps in (((v, key0, lab0), 10), ((v16, key16, lab16_0), 5)):  # relax: plain, statistics, y0
            for kw in ({}, {"stats": True}, {"fwd_scan": True}):
                for _ in range(reps):
                    relax.relax_block_kernel(*planes, s, **kw)
            torch.cuda.synchronize()
        sweep_first = []
        flood_level_sweep(img, fresh.clone(), lambda lvl_, first, *call: sweep_first.append(first))
        torch.cuda.synchronize()
    split, rsplit = {}, {}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        t = getattr(e, "device_time_total", 0) / 1e3
        for part, key in (("column scan", "vscan_tiles<false, true, false>"), ("row kernel", "row_ring<false>")):
            if key in e.key:
                split[part] = t / 5
        for part, key in (("v-pass forward", "vscan_tiles<true, true, true>"),
                          ("v-pass backward", "vscan_tiles<true, true, false>"), ("h-pass", "row_ring<true>")):
            if key in e.key:
                rsplit[part] = t / 10
    check(len(split) == 2 and all(t > 0 for t in split.values()), "the profiler saw both launches of bwd_vh")
    check(len(rsplit) == 3 and all(t > 0 for t in rsplit.values()), "the profiler saw the coarse round's three launches")
    # pack's launches at both sides share one kernel name: take them apart in
    # launch order, one device interval each.
    on_card = sorted((e for e in prof.events() if e.device_type.name == "CUDA"), key=lambda e: e.time_range.start)
    packs = [e.time_range.elapsed_us() / 1e3 for e in on_card if "pack_bands" in e.name]
    coarsens = [e.time_range.elapsed_us() / 1e3 for e in on_card if "coarsen_strips" in e.name]
    check(len(packs) == 15 and len(coarsens) == 10, "the profiler saw pack's 15 and coarsen's 10 launches")
    floods = [e.time_range.elapsed_us() / 1e3 for e in on_card if "flood_kernel" in e.name]
    bcasts = [e.time_range.elapsed_us() / 1e3 for e in on_card if "broadcast_rows" in e.name]
    check(len(floods) == 20 + len(sweep_first) and len(bcasts) == 10,
          "the profiler saw the flood kernel's and the broadcast's launches")
    # The legacy round's launches: cfwd_v, and cbwd_vh's column pass and ring
    # row pass (10 windowed, then 10 full width).
    cfwds = [e.time_range.elapsed_us() / 1e3 for e in on_card if "v_pass<true, true>" in e.name]
    vcols = [e.time_range.elapsed_us() / 1e3 for e in on_card if "v_pass<true, false>" in e.name]
    hwins = [e.time_range.elapsed_us() / 1e3 for e in on_card if "hwin_ring" in e.name]
    check(len(cfwds) == 10 and len(vcols) == len(hwins) == 20, "the profiler saw the legacy round's launches")
    relax_dev = {}  # relax_kernel<stats, rect, scan>: 10 launches at 4096^2, then 5 at 16384^2
    for kind, tmpl in (("plain", "relax_kernel<false, false, false>"), ("statistics", "relax_kernel<true, false, false>"),
                       ("y0", "relax_kernel<true, false, true>")):
        ts = [e.time_range.elapsed_us() / 1e3 for e in on_card if tmpl in e.name]
        check(len(ts) == 15, f"the profiler saw the relax kernel's {kind} launches")
        relax_dev[kind] = (float(np.median(ts[:10])), float(np.median(ts[10:])))
    leg = {"cfwd_v": float(np.median(cfwds)), "column pass": float(np.median(vcols)),
           "ring row pass windowed": float(np.median(hwins[:10])), "ring row pass full width": float(np.median(hwins[10:]))}
    dev_ms = {"pack": float(np.median(packs[:10])), "pack 16384": float(np.median(packs[10:])),
              "relax": relax_dev["plain"][0], "relax2d": relax_dev["plain"][1], "relax_y0": relax_dev["y0"][0],
              "coarsen": float(np.median(coarsens)), "flood": float(np.median(floods[:10])),
              "coarse_broadcast": float(np.median(bcasts)), "cfwd_v": leg["cfwd_v"],
              "cbwd_vh": leg["column pass"] + leg["ring row pass windowed"]}
    sweep_dev = floods[20:]
    first_dev = [t for t, f in zip(sweep_dev, sweep_first) if f]
    later_dev = [t for t, f in zip(sweep_dev, sweep_first) if not f]
    print(f"[19 time] bwd_vh {BIG}^2 per launch (torch.profiler, mean of 5): column scan {split['column scan']:.4f} ms, "
          f"row kernel {split['row kernel']:.4f} ms; gpu={gpu}")
    print(f"[19 time] first coarse round {SIDE}^2 per launch (torch.profiler, mean of 10): "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in rsplit.items()) + f"; gpu={gpu}")
    print(f"[19 time] legacy round {SIDE}^2 per launch (torch.profiler, median of 10): "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in leg.items())
          + f"; cbwd_vh windowed {leg['column pass'] + leg['ring row pass windowed']:.4f} ms, full width "
          f"{leg['column pass'] + leg['ring row pass full width']:.4f} ms; bound {pass_bounds['cbwd_vh'][0]:.4f} ms "
          f"each pass; gpu={gpu}")
    print(f"[19 time] device time (torch.profiler, median of 10, 5 at {BIG}^2): pack {SIDE}^2 {dev_ms['pack']:.4f} ms, "
          f"pack {BIG}^2 {dev_ms['pack 16384']:.4f} ms, coarsen {SIDE}^2 {dev_ms['coarsen']:.4f} ms; CUDA events around "
          f"one call: {pack_ms:.4f}, {big_ms['pack'][0]:.4f} and {coarsen_ms:.4f} ms; gpu={gpu}")
    print(f"[19 time] flood {SIDE}^2 device time (torch.profiler): busy call {dev_ms['flood']:.4f} ms (median of 10), "
          f"every tile skipped {float(np.median(floods[10:20])):.4f} ms (median of 10); the uniform level sweep's "
          f"{len(sweep_dev)} calls {sum(sweep_dev):.3f} ms in all: {len(first_dev)} first calls of a level "
          f"{float(np.mean(first_dev)):.4f} ms mean ({float(np.median(first_dev)):.4f} median), {len(later_dev)} later "
          f"calls {float(np.mean(later_dev)) if later_dev else 0.0:.4f} ms mean; broadcast {SIDE}^2 "
          f"{dev_ms['coarse_broadcast']:.4f} ms (median of 10); CUDA events around one call: {flood_ms:.4f}, "
          f"{skip_ms:.4f} and {bcast_ms:.4f} ms; gpu={gpu}")
    print(f"[19 time] relax_kernel device time (torch.profiler, median of 10 at {SIDE}^2, 5 at {BIG}^2), plain / "
          f"statistics / y0: " + ", ".join(f"{k} {a:.4f} / {b:.4f} ms" for k, (a, b) in relax_dev.items())
          + f"; gpu={gpu}")
    del round_in, round_scratch, c_fin, leg_in, leg_scratch
    del big, exact16, y16, scratch16, lab16, dots16_dev  # v16, key16, lab16_0 serve phase 26

    # How the fine passes scale with the side, on one label draw per side.
    gen = torch.Generator(device=dev).manual_seed(5)
    for side in (SIDE, 2 * SIDE, BIG):
        lab = torch.randint(1, 1 << 26, (side, side), device=dev, dtype=torch.int32, generator=gen)
        lab[torch.rand((side, side), device=dev, generator=gen) < 0.1] = 0
        y = sm.fwd_v_kernel(lab)[0]
        scratch = torch.empty_like(y)
        f_ms = median_ms(lambda: sm.fwd_v_kernel(lab), 10)
        b_ms = median_ms(lambda: sm.bwd_vh_kernel(y, scratch=scratch), 10)
        print(f"[19 time] {side}^2 random labels (10% unclaimed): fwd_v {f_ms:.4f} ms, bwd_vh {b_ms:.4f} ms, "
              f"bound {bound(side * side * 8, 0)[0]:.4f} ms each; gpu={gpu}")
        del lab, y, scratch

    # -- 20: the single-device options: checkpoints, the random tie-break, native
    from rustronomy_watershed_tpu_torch.ops import merge_curve as mc
    from rustronomy_watershed_tpu_torch.ops.ckpt_relax import ckpt_transform, plane_fingerprint
    from rustronomy_watershed_tpu_torch.utils.checkpoint import TransformCheckpointer

    ckpt_root = os.path.join(HERE, "build", "smoke_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)

    def builder(variant, device=None, **opts):
        """``build_<variant>()`` of a builder on ``device`` (the card by
        default) with the named setters called."""
        tb = TransformBuilder.default().set_device(device or dev)
        for setter, args in opts.items():
            tb = getattr(tb, setter)(*args)
        return getattr(tb, f"build_{variant}")()

    def timed(fn):
        """``(result, wall ms)`` of ``fn()``, the card synchronised around it."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def no_twin(counts, what):
        check(sum(counts[f"{k}_plain"] for k in _ext.KERNELS) == 0, f"no plain twin on {what}")

    def interrupted_by(fn) -> str:
        """The message of the RuntimeError that ``fn`` is meant to raise (a
        forced interrupt), or '' when it returned."""
        try:
            fn()
        except RuntimeError as e:
            return str(e)
        return ""

    # The packed engine's plane snapshots at 4096^2: uniform segmenting and
    # NaN-dot merging (the coarse tail).
    path_kernels = {"segmenting": ("relax",), "merging": ("relax", "coarsen", "coarse_round", "coarse_broadcast")}
    for variant, label, field_np, other_np in (("segmenting", f"uniform {SIDE}^2", img_np, dots),
                                               ("merging", f"10% 255-dots {SIDE}^2", dots, img_np)):
        merging = variant == "merging"
        seeds_f, seeds_o = ws.find_local_minima(field_np), ws.find_local_minima(other_np)
        plain_b = builder(variant)
        _ext.reset_launches()
        want = plain_b.transform(field_np, seeds_f, device_output=True)
        calls = _ext.launches["relax"]
        folder = os.path.join(ckpt_root, variant)
        ck = builder(variant, set_checkpoint=(folder, 1))
        _ext.reset_launches()
        got = ck.transform(field_np, seeds_f, device_output=True)
        counts = dict(_ext.launches)
        check(got.device.type == dev.type and torch.equal(got, want), f"checkpointed {variant} {label} == plain transform")
        check(all(counts[k] > 0 for k in path_kernels[variant]) and counts["relax"] == calls,
              f"the checkpointed {variant} transform launched {', '.join(path_kernels[variant])}")
        no_twin(counts, f"the checkpointed {variant} transform")
        files = os.listdir(folder)
        check(len(files) == 1 and files[0].startswith("planes-"), f"one plane snapshot file ({variant})")
        snap_file = os.path.getsize(os.path.join(folder, files[0]))
        # A forced interrupt after 2 relax calls, then the public builder resumes.
        shutil.rmtree(folder)
        img_t, lab0_t = to_dev(field_np), to_dev(paint_seeds(field_np.shape, seeds_f))
        msg = interrupted_by(lambda: ckpt_transform(
            img_t, lab0_t, merging=merging, n_labels=len(seeds_f), checkpointer=TransformCheckpointer(folder, 1),
            device=dev, _interrupt_after_calls=2))
        check(msg == "forced interrupt after 2 calls", f"the {variant} run stopped after relax call 2")
        _ext.reset_launches()
        got = ck.transform(field_np, seeds_f, device_output=True)
        resumed = dict(_ext.launches)
        check(torch.equal(got, want), f"{variant} resumed after call 2 == plain transform")
        check(resumed["relax"] == max(calls - 2, 1), f"the resumed {variant} run started after relax call 2")
        no_twin(resumed, f"the resumed {variant} transform")
        # Another field of the same shape: this field's snapshot, also copied
        # under the other field's name, is not resumed.
        fp_o = plane_fingerprint(other_np, paint_seeds(other_np.shape, seeds_o), merging=merging, max_water_level=254,
                                 steps=relax.DEFAULT_STEPS, d_bits=relax._D_BITS)
        (snap,) = os.listdir(folder)
        shutil.copy(os.path.join(folder, snap), os.path.join(folder, f"planes-{fp_o}.npz"))
        _ext.reset_launches()
        want_o = plain_b.transform(other_np, seeds_o, device_output=True)
        calls_o = _ext.launches["relax"]
        _ext.reset_launches()
        got_o = ck.transform(other_np, seeds_o, device_output=True)
        check(torch.equal(got_o, want_o) and _ext.launches["relax"] == calls_o,
              f"a stale snapshot of another field is not resumed ({variant})")
        # Walls: no checkpoint, every=1 (a snapshot each call) and the
        # default every=16, fresh directories, in turns.
        walls = {"none": [], "every=1": [], "every=16": []}
        for _ in range(3):
            walls["none"].append(timed(lambda: plain_b.transform(field_np, seeds_f, device_output=True))[1])
            for every in (1, 16):
                shutil.rmtree(folder)
                b_every = builder(variant, set_checkpoint=(folder, every))
                walls[f"every={every}"].append(timed(lambda: b_every.transform(field_np, seeds_f, device_output=True))[1])
        check((len(os.listdir(folder)) > 0) == (calls >= 16), f"every=16 snapshots iff the fixed point takes 16 calls")
        shutil.rmtree(folder)
        print(f"[20 checkpoint] {label} {variant}: set_checkpoint(every=1) == plain transform ({calls} relax calls, "
              f"launches {counts}); interrupted after relax call 2 and resumed in {resumed['relax']} calls == plain; "
              f"a stale snapshot of another field ignored; snapshot file {snap_file} bytes")
        print(f"[20 time] {label} {variant} transform wall ms (median of 3, in turns): no checkpoint "
              f"{np.median(walls['none']):.3f}, every=1 {np.median(walls['every=1']):.3f}, every=16 "
              f"{np.median(walls['every=16']):.3f} ({'no snapshot' if calls < 16 else 'snapshots'}: {calls} calls); "
              f"runs {walls}; gpu={gpu}")

    # One plane snapshot, the two int32 planes from the card into the file.
    tmp_ckpt = TransformCheckpointer(os.path.join(ckpt_root, "timing"), 1)
    key_s, lab_s, _ = relax.relax_packed_planes(img, None, device=dev)
    for side, planes in ((SIDE, (key_s, lab_s)), (BIG, (torch.zeros((BIG, BIG), dtype=torch.int32, device=dev),) * 2)):
        ms = [timed(lambda: tmp_ckpt.save_planes(1, *planes, f"timing{side}"))[1] for _ in range(3)]
        size = os.path.getsize(os.path.join(ckpt_root, "timing", f"planes-timing{side}.npz"))
        t_load, ms_load = timed(lambda: tmp_ckpt.latest_planes(f"timing{side}"))
        check(np.array_equal(t_load["lab"], planes[1].cpu().numpy()), f"the {side}^2 snapshot reads back")
        print(f"[20 time] plane snapshot {side}^2: {2 * side * side * 4} bytes of planes, file {size} bytes; save "
              f"{np.median(ms):.1f} ms (median of 3: {[round(m, 1) for m in ms]}), read {ms_load:.1f} ms; gpu={gpu}")
        del t_load
    del key_s, lab_s, planes
    shutil.rmtree(ckpt_root)

    # The host loop's per-level snapshots on the flood kernel (backend 'pallas')
    # at 1024^2: a hook that raises at level 100, then a resumed run.
    hooked = builder("segmenting", set_backend=("pallas",), set_wlvl_hook=(digest,))
    _ext.reset_launches()
    full_hooks, hook_ms = timed(lambda: hooked.transform_with_hook(pimg, pseeds))
    counts = dict(_ext.launches)
    check(counts["flood"] > 0, "the hooked level sweep launched the flood kernel")
    no_twin(counts, "the hooked level sweep")
    check(full_hooks == builder("segmenting", set_wlvl_hook=(digest,)).transform_with_hook(pimg, pseeds),
          "hooks on the flood kernel's host loop == the packed engine's replay")

    def boom(ctx):
        if ctx.water_level == 100:
            raise RuntimeError("interrupted at level 100")
        return digest(ctx)

    folder = os.path.join(ckpt_root, "levels")
    msg = interrupted_by(lambda: builder("segmenting", set_backend=("pallas",), set_checkpoint=(folder, 16),
                                         set_wlvl_hook=(boom,)).transform_with_hook(pimg, pseeds))
    check(msg == "interrupted at level 100", "the hook interrupted the level loop at level 100")
    _ext.reset_launches()
    resumed_hooks, resume_ms = timed(lambda: builder("segmenting", set_backend=("pallas",), set_checkpoint=(folder, 16),
                                                     set_wlvl_hook=(digest,)).transform_with_hook(pimg, pseeds))
    counts = dict(_ext.launches)
    check(resumed_hooks == full_hooks[97:], "the resumed level loop's hooks == the uninterrupted run's from level 97")
    check(counts["flood"] > 0, "the resumed level loop launched the flood kernel")
    no_twin(counts, "the resumed level loop")
    shutil.rmtree(ckpt_root)
    print(f"[20 checkpoint] golden_morph_v1 1024^2 segmenting, backend 'pallas', hook, set_checkpoint(every=16): "
          f"interrupted at level 100, resumed at level 97, its {len(resumed_hooks)} hook views == the uninterrupted "
          f"run's; launches {counts}; walls {hook_ms:.1f} ms uninterrupted, {resume_ms:.1f} ms resumed; gpu={gpu}")

    # The random tie-break at 1024^2: segmenting labels on the card == on the
    # CPU for one seed, another seed's differ, the claimed set is the min
    # rule's; merging labels are the min rule's for every seed (the CPU's
    # merging level sweep would take minutes here).
    pois = poisson_u8((1024, 1024))
    seeds_p = ws.find_local_minima(pois)
    min_p = ws.transform(pois, seeds_p)
    _ext.reset_launches()
    rnd, rnd_ms = timed(lambda: builder("segmenting", set_tie_break=("random", 1)).transform(pois, seeds_p,
                                                                                             device_output=True))
    check(rnd.device.type == dev.type, "the random segmenting run computed on the card")
    check(sum(_ext.launches[k] for k in _ext.KERNELS) == 0, "the random rule runs on no kernel")
    cpu_rnd, cpu_ms = timed(lambda: builder("segmenting", "cpu", set_tie_break=("random", 1)).transform(pois, seeds_p))
    check(np.array_equal(rnd.cpu().numpy(), cpu_rnd), "random segmenting: the card == the CPU for one seed")
    check(not np.array_equal(builder("segmenting", set_tie_break=("random", 2)).transform(pois, seeds_p), cpu_rnd),
          "random segmenting: another seed gives other labels")
    check(np.array_equal(cpu_rnd != 0, min_p != 0), "random segmenting: the claimed set == the min rule's")
    want_m = wm.transform(pois, seeds_p)
    rnd_m, rnd_m_ms = timed(lambda: builder("merging", set_tie_break=("random", 1)).transform(pois, seeds_p,
                                                                                             device_output=True))
    check(rnd_m.device.type == dev.type and np.array_equal(rnd_m.cpu().numpy(), want_m)
          and np.array_equal(builder("merging", set_tie_break=("random", 2)).transform(pois, seeds_p), want_m),
          "random merging on the card == the min rule's merging labels, for seeds 1 and 2")
    print(f"[20 random] Poisson(30) 1024^2 ({len(seeds_p)} seeds): set_tie_break('random', 1) segmenting on the card "
          f"== on the CPU, {int((cpu_rnd != min_p).sum())} pixels differ from the min rule, seed 2 differs, the "
          f"claimed set is the min rule's; merging == the min rule for seeds 1 and 2; level sweep segmenting "
          f"{rnd_ms:.1f} ms on the card, {cpu_ms:.1f} ms on the CPU; merging {rnd_m_ms:.1f} ms on the card; gpu={gpu}")
    del rnd, rnd_m
    rnd_g, rnd_g_ms = timed(lambda: builder("segmenting", set_tie_break=("random", 1)).transform(pimg, pseeds,
                                                                                                  device_output=True))
    check(torch.equal(rnd_g != 0, torch.from_numpy(ws.transform(pimg, pseeds) != 0).to(dev)),
          "random golden_morph_v1: the claimed set == the min rule's")
    print(f"[20 time] golden_morph_v1 1024^2 segmenting, random tie-break, level sweep on the card {rnd_g_ms:.1f} ms; "
          f"gpu={gpu}")
    del rnd_g

    # The native engine at 1024^2 against 'auto', and the to_list host tail:
    # the native pass against its NumPy twin, in turns.
    for variant in ("segmenting", "merging"):
        nat, auto_b = builder(variant, set_backend=("native",)), build(variant, "auto")
        got, nat_ms = timed(lambda: nat.transform(pimg, pseeds))
        check(np.array_equal(got, auto_b.transform(pimg, pseeds)), f"native {variant} == 'auto'")
        k1 = len(pseeds) + 1
        rows_nat, nat_list_ms = timed(lambda: nat.transform_to_list(pimg, pseeds, counts_length=k1))
        tails = {"native": [], "numpy": []}
        native_tail = mc.merged_curve_host
        for _ in range(3):
            rows_auto, t_ = timed(lambda: auto_b.transform_to_list(pimg, pseeds, counts_length=k1))
            tails["native"].append(t_)
            mc.merged_curve_host = mc.merged_curve_plain
            try:
                rows_np, t_ = timed(lambda: auto_b.transform_to_list(pimg, pseeds, counts_length=k1))
            finally:
                mc.merged_curve_host = native_tail
            tails["numpy"].append(t_)
        check(all(a[0] == b[0] == c[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[1], c[1])
                  for a, b, c in zip(rows_nat, rows_auto, rows_np)), f"native {variant} to_list == 'auto' on both tails")
        print(f"[20 native] golden_morph_v1 1024^2 {variant}: set_backend('native') == 'auto' (transform, to_list); "
              f"native transform {nat_ms:.1f} ms, to_list {nat_list_ms:.1f} ms (host); 'auto' to_list on the native "
              f"tail {np.median(tails['native']):.1f} ms, on the NumPy tail {np.median(tails['numpy']):.1f} ms "
              f"(median of 3 in turns: {tails}); gpu={gpu}")

    mesh = mesh_phases(types.SimpleNamespace(
        dev=dev, gpu=gpu, to_dev=to_dev, median_ms=median_ms, timed=timed,
        builder=builder, ws=ws, v=v, key0=key0, lab0=lab0, img_np=img_np, dots=dots, pimg=pimg, pseeds=pseeds,
    ))

    late_phases(types.SimpleNamespace(dev=dev, gpu=gpu, to_dev=to_dev, timed=timed, builder=builder, ws=ws))

    y0 = y0_phase(types.SimpleNamespace(
        gpu=gpu, to_dev=to_dev, median_ms=median_ms, planes=(v, key0, lab0), planes16=(v16, key16, lab16_0),
        fields={"uniform": img_np, "10% dots": dots, "seed lattice": seed_lattice((SIDE, SIDE)),
                "cone lattice": cone_lattice((SIDE, SIDE))},
    ))
    print(f"[26 y0] relax_kernel device time (phase 19's profiler session): y0 {dev_ms['relax_y0']:.4f} ms at "
          f"{SIDE}^2, {relax_dev['y0'][1]:.4f} ms at {BIG}^2; gpu={gpu}")
    del v16, key16, lab16_0

    # Bytes each function must move at 4096^2 (each input read once, each
    # output written once) and the integer operations it does per cell.
    bounds = {
        "pack": bound(px * (1 + 1 + 4 + 4), px * 20),  # 8 compares + numbering per pixel
        "relax": relax_bound,
        "relax_ctr": mesh["bound"],  # at the 1x1 mesh's padded planes
        "relax_y0": y0["bound"],  # relax's planes and the y0 plane out
        "coarsen": bound(px * 4 + cells * 4, cells * 40),
        "coarse_round": round_bound,
        "coarse_broadcast": bound(px * 4 + cells * 4 + px * 4, px * 6),
        "flood": bound(px * (1 + 4 + 4), px * fs * 12),  # image + labels in, labels out; ~12 ops per cell and sweep
        **{k: big_bounds[k] for k in ("relax2d", "fwd_v", "bwd_vh")},  # at 16384^2
        **{k: pass_bounds[k] for k in ("cfwd_v", "cbwd_vh")},
    }
    dot_counts = merge_runs["10% dots"]
    rows = [
        ("pack", "csrc/pack.cu", "rustronomy_watershed_tpu/ops/pallas_pack.py:85", launches["pack"], pack_err, pack_ms, pack_plain_ms),
        ("relax", "csrc/relax.cu", "rustronomy_watershed_tpu/ops/pallas_relax.py:254", launches["relax_launched"], relax_err,
         relax_ms, relax_plain_ms),
        ("coarsen", "csrc/coarsen.cu", "rustronomy_watershed_tpu/ops/scan_merge.py:687", dot_counts["coarsen"],
         coarse_err["coarsen"], coarsen_ms, coarsen_plain_ms),
        ("coarse_round", "csrc/scan_round.cu", "rustronomy_watershed_tpu/ops/scan_merge.py:1001",
         dot_counts["coarse_round_launched"],
         coarse_err["coarse_round"], round_ms, round_plain_ms),
        ("coarse_broadcast", "csrc/coarse_broadcast.cu", "rustronomy_watershed_tpu/ops/scan_merge.py:1185",
         dot_counts["coarse_broadcast"], coarse_err["coarse_broadcast"], bcast_ms, bcast_plain_ms),
        ("flood", "csrc/flood.cu", "rustronomy_watershed_tpu/ops/pallas_flood.py:106",
         level_runs[(f"uniform {SIDE}^2", "segmenting")]["flood"] + mesh["flood_launches"],
         max(flood_err, mesh["flood_err"]), flood_ms, flood_plain_ms),
        ("relax2d", "csrc/relax.cu", "rustronomy_watershed_tpu/ops/pallas_relax.py:920",
         big_runs[("10% dots", "merging")]["relax_launched"], relax2d_err, *big_ms["relax2d"]),
        ("fwd_v", "csrc/scan_round.cu", "rustronomy_watershed_tpu/ops/scan_merge.py:129",
         big_runs[("10% dots", "merging")]["fwd_v"], fine_err["fwd_v"], *big_ms["fwd_v"]),
        ("bwd_vh", "csrc/scan_round.cu", "rustronomy_watershed_tpu/ops/scan_merge.py:212",
         big_runs[("10% dots", "merging")]["bwd_vh"], fine_err["bwd_vh"], *big_ms["bwd_vh"]),
        ("cfwd_v", "csrc/scan_round.cu", "rustronomy_watershed_tpu/ops/scan_merge.py:836",
         legacy_counts["cfwd_v"], legacy_err["cfwd_v"], *pass_ms["cfwd_v"]),
        ("cbwd_vh", "csrc/scan_round.cu", "rustronomy_watershed_tpu/ops/scan_merge.py:898",
         legacy_counts["cbwd_vh"], legacy_err["cbwd_vh"], *pass_ms["cbwd_vh"]),
        ("relax_ctr", "csrc/relax.cu", "rustronomy_watershed_tpu/ops/pallas_relax.py:268",
         mesh["launches"], mesh["err"], mesh["ms"], mesh["plain_ms"]),
        ("relax_y0", "csrc/relax.cu", "rustronomy_watershed_tpu/ops/pallas_relax.py:541 (and :1134)",
         y0["launches"], y0["err"], y0["ms"], y0["plain_ms"]),
    ]
    kernels = []
    for kname, src, replaces, n, err, ms, plain_ms in rows:
        check(n > 0 and err == 0, f"{kname}: launched on its path and bit-equal to its twin")
        b_ms, b_by = bounds[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=f"rustronomy_watershed_tpu_torch/{src}", replaces=replaces,
            launches=n, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None,  # no single PyTorch call computes any of these functions
        ))
        device = f", device {dev_ms[kname]:.4f} ms (profiler)" if kname in dev_ms else ""
        print(f"[27 bound] {kname}: {ms:.4f} ms{device} against a bound of {b_ms:.4f} ms ({b_by}); gpu={gpu}")
    pb_ms, pb_by = big_bounds["pack"]
    print(f"[27 bound] pack {BIG}^2: {big_ms['pack'][0]:.4f} ms, device {dev_ms['pack 16384']:.4f} ms (profiler) "
          f"against a bound of {pb_ms:.4f} ms ({pb_by}); plain {big_ms['pack'][1]:.3f} ms; gpu={gpu}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
