"""Build, load and count the hand-written CUDA kernels.

At first use ``nvcc`` compiles every ``csrc/*.cu`` file for Hopper
(``sm_90a``), one process per source, all started together, and links the
objects into one shared library with a plain C interface, under
``build/rwt_torch_kernels/<hash of the sources>/libkernels.so`` beside the
package; ``ctypes`` loads it.  Nothing is built at import time, and nothing
but the repository's own sources goes into the library.

Each kernel wrapper (ops/pack.py, ops/relax.py, ops/scan_merge.py,
ops/flood_block.py) adds one to ``launches`` where it launches its kernel,
and its plain-PyTorch twin adds one to the ``*_plain`` entry, so a run can
show which path it took.  The merging driver also records its route per
transform: ``merge_shortcut`` (the single-component broadcast) or
``merge_tail`` (the component-min tail, coarse or fine); the level sweep's merge phase
counts its label-table rounds as ``merge_round`` (ops/merge.py).  The fine
``bwd_vh`` kernel also counts the route of its row launch: ``bwd_vh_ring``
(the shared-memory ring row kernel) or ``bwd_vh_chunked`` (rows wider than
the ring), and so do ``coarse_round`` (``coarse_round_ring`` /
``coarse_round_chunked``) and the legacy ``cbwd_vh`` (``cbwd_vh_ring`` /
``cbwd_vh_chunked``); ``pack`` counts its route as ``pack_vec`` (the
band kernel with 16-byte access), ``pack_bytes`` (the band kernel with byte
access) or ``pack_rows`` (rows wider than a band block), and ``coarsen`` as
``coarsen_vec`` (column strips) or ``coarsen_cells`` (a thread per cell),
and ``coarse_broadcast`` as ``coarse_broadcast_vec`` (int4 columns over
both fine rows) or ``coarse_broadcast_cells`` (a thread per cell).  The
flood kernel counts its calls that ran with tile state (``flood_tiles``),
the tiles whose sweeps those calls skipped (``flood_tiles_skipped``) and,
of those, the tiles that copied their centre to keep the ping-pong planes
in sync (``flood_tiles_copied``).  ``relax_ctr`` counts the relax launches
whose flags cover a centre rectangle smaller than the plane (a mesh tile's,
parallel/tiled.py), ``relax_y0`` those that ran the y0 epilogue
(``fwd_scan=True``).  ``relax_tiles`` adds each relax launch's tiles (its
plan's ``n_tiles``) and ``relax_tiles_skipped`` the quiet tiles a skipping
fixed point's launches skipped, as the host reads them with the flags;
``relax_px_run`` the pixels of the centre tiles that each relax launch ran,
clipped to the plane (a skipped tile adds 0; read with the flags too, or
``h * w`` at the launch of a call without tile state), and
``relax_sweeps`` each relax launch's ``steps``, and ``relax_calls_sparse``
the launches of a skipping fixed point that ran fewer than an eighth of
their plan's tiles (a front of the flood, not the plane; counted from the
same read).
``relax_launched`` counts every relax launch as it is queued; ``relax``
(with ``relax_tiles``, ``relax_sweeps``, ``relax_ctr`` and, without tile
state, ``relax_px_run``) the launches that ran, and ``relax_stopped`` those
that a fixed point queued past its end and that stopped on the device,
because the call before them certified it (ops/relax.py
``relax_fixed_point``, which counts both once it has read a block of
flags): the two add up to ``relax_launched``.  The twin counts its calls
that stopped in ``relax_stopped`` too.  ``relax_reads`` counts the fixed
point's reads of its flags, one a block (also in ``host_reads``).
``coarse_round_launched`` counts every launch of the coarse round, as it
is queued, and ``coarse_round_ring`` / ``coarse_round_chunked`` its row
route; ``coarse_round`` counts the rounds that ran, ``coarse_round_skipped``
those the merging tail queued that stopped on the device, because a round
before them changed nothing (ops/scan_merge.py ``_coarse_rounds``, which
counts both once it has read a block's change counts): the two add up to
``coarse_round_launched``.
``fine_tail`` counts the calls of the fine scan tail (ops/scan_merge.py
``component_min_fine``) and ``fine_round`` their rounds, each ended by one
flag read (also in ``host_reads``); the legacy coarse rounds count in
neither.
``host_reads`` counts the program's explicit blocking reads of a result on
the transforms' paths, each made through ``host_read``: a block of relax
calls' flags, a block of coarse rounds' change counts, a legacy or fine tail
round's flag, the seed list, the compact planes of
``transform_to_list`` and the labels or sizes a public call returns.  A sync
inside a torch op (``nonzero``, boolean-mask indexing, ``unique``, a copy
from pageable memory) is not counted.
``curve_block_reused`` and ``curve_block_new`` count the pooled-size result
blocks of the merged-curve tail (ops/merge_curve.py ``ResultBlocks``): taken
from the pool of released blocks, or mapped fresh.
``seed_array_flat`` and ``seed_array_generic`` count the seed lists that
``ops/seeds.py::seed_array`` turned into coordinates: read as one flat stream
of pairs, or through ``np.asarray`` (an array input counts in neither).
``pre_process_px`` counts the pixels that ``ops/preprocess.py::
pre_process_jnp`` quantised.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "rwt_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

KERNELS = (
    "pack", "relax", "coarsen", "coarse_round", "coarse_broadcast", "flood",
    "fwd_v", "bwd_vh", "cfwd_v", "cbwd_vh",
)
launches = {
    **{k: 0 for k in KERNELS},
    **{f"{k}_plain": 0 for k in KERNELS},
    "merge_shortcut": 0,
    "merge_tail": 0,
    "merge_round": 0,
    "bwd_vh_ring": 0,
    "bwd_vh_chunked": 0,
    "coarse_round_ring": 0,
    "coarse_round_chunked": 0,
    "cbwd_vh_ring": 0,
    "cbwd_vh_chunked": 0,
    "pack_vec": 0,
    "pack_bytes": 0,
    "pack_rows": 0,
    "coarsen_vec": 0,
    "coarsen_cells": 0,
    "coarse_broadcast_vec": 0,
    "coarse_broadcast_cells": 0,
    "flood_tiles": 0,
    "flood_tiles_skipped": 0,
    "flood_tiles_copied": 0,
    "relax_ctr": 0,
    "relax_y0": 0,
    "relax_tiles": 0,
    "relax_tiles_skipped": 0,
    "relax_px_run": 0,
    "relax_sweeps": 0,
    "relax_calls_sparse": 0,
    "relax_launched": 0,
    "relax_stopped": 0,
    "relax_reads": 0,
    "coarse_round_launched": 0,
    "coarse_round_skipped": 0,
    "fine_tail": 0,
    "fine_round": 0,
    "host_reads": 0,
    "curve_block_reused": 0,
    "curve_block_new": 0,
    "seed_array_flat": 0,
    "seed_array_generic": 0,
    "pre_process_px": 0,
}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def host_read(t: torch.Tensor, to: str = "list", after=None):
    """``t.tolist()``, ``t.item()`` (``to="item"``) or ``t.cpu().numpy()``
    (``to="numpy"``): a read of a result that waits for the device, counted
    in ``host_reads``.  ``after``: a CUDA event to wait for first, when
    ``t`` is host memory that a copy queued before the event fills."""
    launches["host_reads"] += 1
    if after is not None:
        after.synchronize()
    if to == "item":
        return t.item()
    return t.cpu().numpy() if to == "numpy" else t.tolist()


_SM_COUNT: dict = {}


def sm_count(dev) -> int:
    """Streaming multiprocessors of CUDA device ``dev`` (a device or its
    index; cached)."""
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNT[dev]


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device on a host without CUDA
    raises instead of running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libkernels.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the first failure's
    output once all have ended."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")


def build() -> Path:
    """Compile the kernels unless this exact source set is already built."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # Build in a private directory, then rename: concurrent builders never
    # load a half-written library.
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in _sources()]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            for src, obj in zip(_sources(), objs)
        ])
        lib_tmp = os.path.join(tmp, out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs]])
        os.replace(lib_tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        L.rwt_pack.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, P]
        L.rwt_pack.restype = I
        L.rwt_relax.argtypes = [P] * 13 + [I] * 14 + [P]
        L.rwt_relax.restype = I
        L.rwt_coarsen.argtypes = [P, P, I, I, I, I, I, I, I, P]
        L.rwt_coarsen.restype = I
        L.rwt_coarse_round.argtypes = [P] * 6 + [I] * 7 + [P]
        L.rwt_coarse_round.restype = I
        L.rwt_coarse_broadcast.argtypes = [P, P, P] + [I] * 7 + [P]
        L.rwt_coarse_broadcast.restype = I
        L.rwt_flood.argtypes = [P] * 7 + [I] * 13 + [P]
        L.rwt_flood.restype = I
        L.rwt_fine_fwd_v.argtypes = [P, P, P, P, I, I, I, P]
        L.rwt_fine_fwd_v.restype = I
        L.rwt_fine_bwd_vh.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P]
        L.rwt_fine_bwd_vh.restype = I
        L.rwt_coarse_fwd_v.argtypes = [P, P, P, I, I, P]
        L.rwt_coarse_fwd_v.restype = I
        L.rwt_coarse_bwd_vh.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
        L.rwt_coarse_bwd_vh.restype = I
        L.rwt_error_string.argtypes = [I]
        L.rwt_error_string.restype = ctypes.c_char_p
        _lib = L
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = lib().rwt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device (the call
    PyTorch's own Triton launcher makes: no Stream object per launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
