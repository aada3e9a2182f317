"""Build, load and count the hand-written CUDA kernels.

At first use ``nvcc`` compiles every ``csrc/*.cu`` file for Hopper
(``sm_90a``) into one shared library with a plain C interface, under
``build/rwt_torch_kernels/<hash of the sources>/libkernels.so`` beside the
package, and ``ctypes`` loads it.  Nothing is built at import time, and
nothing but the repository's own sources goes into the library.

Each kernel wrapper (ops/pack.py, ops/relax.py) adds one to ``launches``
where it launches its kernel, and its plain-PyTorch twin adds one to the
``*_plain`` entry, so a run can show which path it took.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

launches = {"pack": 0, "relax": 0, "pack_plain": 0, "relax_plain": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


def build() -> Path:
    """Compile the kernels unless this exact source set is already built."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # Build into a private file, then rename: concurrent builders never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        L.rwt_pack.argtypes = [P, P, P, P, P, P, I, I, I, P]
        L.rwt_pack.restype = I
        L.rwt_relax.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
        L.rwt_relax.restype = I
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
    return torch.cuda.current_stream(t.device).cuda_stream
