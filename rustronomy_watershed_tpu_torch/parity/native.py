"""ctypes binding of the native C++ engine (``oracle.cc``), built at first use.

Counterpart of ``rustronomy_watershed_tpu.parity.native``: the reference
semantics under the min-label tie-break in one host pass, serving
``set_backend("native")`` and the merged-curve tail of ``transform_to_list``
/ ``transform_history`` (ops/merge_curve.py).  ``g++ -O3 -shared -fPIC``
compiles ``oracle.cc`` once into
``build/rwt_native/<hash>/liboracle.so`` beside the package (the hash
covers the source, the flags, the compiler's version and the machine); a
failed build raises, nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "oracle.cc"
BUILD_ROOT = _SRC.parents[2] / "build" / "rwt_native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None


def _run(cmd: list[str]) -> str:
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native engine build: cannot run {cmd[0]!r} ({e})") from e
    if done.returncode != 0:
        raise RuntimeError(f"native engine build failed ({done.returncode}): {' '.join(cmd)}\n{done.stderr}")
    return done.stdout


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(_run([CXX, "--version"]).encode())
    h.update(platform.machine().encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "liboracle.so"


def build() -> Path:
    """Compile ``oracle.cc`` unless this exact build exists; raise if the
    compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # Build in a private directory, then rename: concurrent builders never
    # load a half-written library.
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        so = os.path.join(tmp, out.name)
        _run([CXX, *CXX_FLAGS, str(_SRC), "-o", so])
        os.replace(so, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded engine (built on first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        L.watershed_oracle.argtypes = [P, I64, I64, P, I64, I, I, P]
        L.watershed_oracle.restype = I
        L.local_extrema_oracle.argtypes = [P, I64, I64, P]
        L.local_extrema_oracle.restype = I
        L.merged_curve_oracle.argtypes = [P, P, I64, I64, I, P, P, P, I64, P, I64]
        L.merged_curve_oracle.restype = I
        _lib = L
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"native {what} failed rc={rc}")


def native_transform(
    img, seeds, max_water_level: int = 254, merging: bool = False,
    edge_correction: bool = False, with_sizes: bool = False,
):
    """The whole transform on the host: int64 labels, or ``(labels, sizes)``
    with the ``(levels, len(seeds) + 1)`` int64 per-level lake sizes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if edge_correction:
        img = np.pad(img, 1, constant_values=0)
    h, w = img.shape
    labels = np.zeros((h, w), dtype=np.int64)
    for col, (y, x) in enumerate(seeds, start=1):
        labels[y, x] = col  # no +1 shift under edge correction (SURVEY.md Q7)
    k = len(seeds)
    sizes = np.zeros((max_water_level + 1, k + 1), dtype=np.int64) if with_sizes else None
    rc = lib().watershed_oracle(
        img.ctypes.data, h, w, labels.ctypes.data, k, int(max_water_level), int(bool(merging)),
        sizes.ctypes.data if with_sizes else None,
    )
    _check(rc, "transform")
    return (labels, sizes) if with_sizes else labels


def native_merged_curve(
    labels, lv8, n_labels: int, max_water_level: int, lo, hi, act, out_width: int | None = None,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """``(levels, out_width or K+1)`` int64 merged per-level lake sizes from
    the compact planes in one pass (counting-sorted level streaming,
    incremental per-root sums); equal to ops/merge_curve.py's NumPy pair.
    The pass writes the first ``min(K+1, out_width)`` columns of each row;
    the others stay zero (untouched calloc pages); representatives at or
    above ``out_width`` are cut.  ``out``: a C-contiguous, writeable int64
    block of that shape to write into and return, which the caller
    guarantees reads 0 outside those columns."""
    labels = np.ascontiguousarray(labels, dtype=np.int32).reshape(-1)
    lv8 = np.ascontiguousarray(lv8, dtype=np.uint8).reshape(-1)
    if lv8.size != labels.size:
        raise ValueError("labels and claim levels differ in size")
    lo, hi, act = (np.ascontiguousarray(a, dtype=np.int32) for a in (lo, hi, act))
    if not lo.size == hi.size == act.size:
        raise ValueError("lo, hi and act differ in length")
    k1, levels = n_labels + 1, max_water_level + 1
    # The C pass indexes its tables with these values unchecked.
    for name, a, top in (("labels", labels, k1), ("claim levels", lv8, levels + 1), ("lo", lo, k1), ("hi", hi, k1),
                         ("act", act, levels)):
        if a.size and (int(a.min()) < 0 or int(a.max()) >= top):
            raise ValueError(f"{name} outside [0, {top})")
    shape = (levels, k1 if out_width is None else out_width)
    if out is None:
        out = np.zeros(shape, dtype=np.int64)
    elif out.shape != shape or out.dtype != np.int64 or not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError(f"out must be a C-contiguous writeable int64 block of shape {shape}")
    rc = lib().merged_curve_oracle(
        labels.ctypes.data, lv8.ctypes.data, labels.size, k1, levels,
        lo.ctypes.data, hi.ctypes.data, act.ctypes.data, lo.size, out.ctypes.data, out.shape[1],
    )
    _check(rc, "merged_curve")
    return out


def native_find_local_minima(img) -> list[tuple[int, int]]:
    """Seed coordinates (strict local maxima, SURVEY.md Q1) in row-major
    order."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    mask = np.zeros(img.shape, dtype=np.uint8)
    _check(lib().local_extrema_oracle(img.ctypes.data, *img.shape, mask.ctypes.data), "local extrema")
    return [tuple(map(int, c)) for c in np.argwhere(mask)]
