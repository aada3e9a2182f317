"""Run a function on several gloo ranks, each its own process, on the CPU.

``run_ranks(fn, n, tmp_path, *args)`` spawns ``n`` processes (the ``spawn``
start method), each joins a gloo process group (or NCCL, a card a rank)
through a ``FileStore`` in ``tmp_path`` (no TCP port) and calls
``fn(rank, *args)``; the parent
collects each rank's return value, joins the ranks with a deadline and
kills them after it.  A rank that raises, dies or outlives the deadline
fails the call.  ``fn`` must be importable by name (a module-level function
of a test helper), and what it returns picklable.

Imports torch and the port only: a rank never imports JAX.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue
import time
import traceback
from datetime import timedelta

import torch


def _rank_main(rank, n, store_path, backend, fn, args, out):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        if backend == "nccl":
            torch.cuda.set_device(rank)  # one card a rank
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n, timeout=timedelta(seconds=120))
        try:
            res = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", res))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the test
        out.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, n: int, tmp_path, *args, deadline: float = 240.0, backend: str = "gloo"):
    """``[fn(0, *args), ..., fn(n - 1, *args)]`` computed on ``n`` ranks of a
    ``backend`` group (gloo; NCCL with rank r on card r)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store-{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_main, args=(r, n, store, backend, fn, args, out)) for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    end = time.monotonic() + deadline
    try:
        # Drain the queue before joining: a rank blocks on exit until its
        # result has been read.
        while len(results) + len(errors) < n:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(n)) - set(results))} missed the {deadline} s deadline")
            try:
                rank, status, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died with exit code {dead[0].exitcode}") from None
                continue
            if status == "ok":
                results[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
        if errors:
            raise RuntimeError("\n".join(errors))
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(n)]


def mesh_of(shape, device_type="cpu"):
    """A ``("y", "x")`` DeviceMesh of the first ``ny * nx`` ranks; every rank
    of the world must build it (ranks outside it get no coordinate)."""
    from torch.distributed.device_mesh import DeviceMesh

    ny, nx = shape
    return DeviceMesh(device_type, torch.arange(ny * nx).reshape(ny, nx), mesh_dim_names=("y", "x"))


@contextlib.contextmanager
def one_rank_group(tmp_path):
    """A one-rank gloo process group in this process (a ``FileStore`` in
    ``tmp_path``), destroyed on exit; yields its 1 x 1 ``("y", "x")`` CPU
    mesh."""
    import torch.distributed as dist

    store = dist.FileStore(os.path.join(str(tmp_path), f"store-{time.monotonic_ns()}"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        yield mesh_of((1, 1))
    finally:
        dist.destroy_process_group()
