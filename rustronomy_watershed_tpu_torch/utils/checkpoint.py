"""Checkpoint / resume of long transforms: one ``.npz`` file per snapshot.

Counterpart of ``rustronomy_watershed_tpu.utils.checkpoint`` without orbax.
Two kinds of snapshot share a directory:

* per-level, ``(water_level, labels)``: the host-stepped loop's carried
  state, saved every ``every`` levels;
* planes, ``(calls, key, lab)``: the packed relax engine's carried planes
  after a kernel call, saved every ``every`` calls (ops/ckpt_relax.py).

Every snapshot carries the fingerprint of the run that wrote it
(``fingerprint``: the prepared image's and painted seeds' bytes, their shape,
and the run's settings), and a run reads only snapshots with its own
fingerprint, so a snapshot of another image or configuration is never
resumed (the JAX package resumes planes by their geometry alone and a
per-level snapshot unchecked; its ``latest`` raises on a plane snapshot).
A snapshot file is named by its kind and fingerprint and holds the newest
snapshot of that run: it is written under a temporary name and moved into
place with ``os.replace``, so a reader sees a whole snapshot or the one
before it.  Writes are synchronous (``wait`` has nothing to wait for) and
not fsynced: a snapshot outlives the process, not the machine; a file that
cannot be read is reported and ignored.
"""

from __future__ import annotations

import hashlib
import os
import warnings
import zipfile
from pathlib import Path

import numpy as np
import torch


def fingerprint(img, labels0, **settings) -> str:
    """Hex digest of the prepared image and painted seeds (numpy arrays or
    tensors on any device: bytes, dtype and shape) and of ``settings``."""
    h = hashlib.sha256()
    for a in (img, labels0):
        a = np.ascontiguousarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
        h.update(repr((a.dtype.str, a.shape)).encode())
        h.update(memoryview(a).cast("B"))
    h.update(repr(sorted(settings.items())).encode())
    return h.hexdigest()


class TransformCheckpointer:
    """Snapshots of one directory; ``every`` counts water levels on the
    host-stepped loop and relax calls on the packed fast path."""

    def __init__(self, directory, every: int = 16):
        self.directory = Path(directory)
        self.every = max(1, int(every))
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, kind: str, fp: str) -> Path:
        return self.directory / f"{kind}-{fp}.npz"

    def _write(self, kind: str, fp: str, **arrays) -> None:
        path = self._path(kind, fp)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, fingerprint=np.array(fp), **arrays)
        os.replace(tmp, path)

    def _read(self, kind: str, fp: str):
        path = self._path(kind, fp)
        if not path.exists():
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                snap = {k: z[k] for k in z.files}
        except (OSError, EOFError, ValueError, zipfile.BadZipFile) as e:
            warnings.warn(f"unreadable snapshot {path} ignored ({e})", RuntimeWarning, stacklevel=3)
            return None
        if str(snap.get("fingerprint")) != fp:
            return None
        return snap

    # -- per-level snapshots (the host-stepped loop) ---------------------------

    def maybe_save(self, water_level: int, labels, fp: str) -> bool:
        """Snapshot ``labels`` after ``water_level`` when the level is a
        multiple of ``every`` (level 0 included)."""
        if water_level % self.every != 0:
            return False
        self._write("levels", fp, water_level=np.int64(water_level), labels=np.asarray(labels, dtype=np.int32))
        return True

    def latest(self, fp: str):
        """``(water_level, labels)`` of the newest per-level snapshot with
        fingerprint ``fp``, or None; plane snapshots are not looked at."""
        snap = self._read("levels", fp)
        if snap is None:
            return None
        return int(snap["water_level"]), snap["labels"]

    # -- relax plane snapshots (ops/ckpt_relax.py) -----------------------------

    def save_planes(self, calls: int, key, lab, fp: str) -> int:
        """Snapshot the packed engine's planes after relax call ``calls``;
        returns the bytes of the two planes."""
        key, lab = (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in (key, lab))
        self._write("planes", fp, calls=np.int64(calls), key=key, lab=lab)
        return key.nbytes + lab.nbytes

    def latest_planes(self, fp: str):
        """``{"calls", "key", "lab"}`` of the newest plane snapshot with
        fingerprint ``fp``, or None."""
        snap = self._read("planes", fp)
        if snap is None:
            return None
        return {"calls": int(snap["calls"]), "key": snap["key"], "lab": snap["lab"]}

    def wait(self) -> None:
        """Nothing to wait for: every save has ended when it returns."""
