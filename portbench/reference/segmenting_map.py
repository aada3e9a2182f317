"""Plain reference of the beam-map deployment: the float32 pre-processor,
then the segmenting watershed of ``reference/segmenting.py`` on its
levels.

``levels(map, max_val)`` is the pre-processor in plain ``torch`` float32
on the CPU, its steps in the order of the reference recipe (upstream's
``pre_processor_with_max``, src/lib.rs:1134-1173, in JAX's float32 form):

* a finite mask, and the map with every non-finite value set to 0;
* ``mn`` = min(0, min), ``mx`` = max(0, max) of that map (folds seeded
  with 0, so the range always holds 0);
* ``denom`` = ``mx - mn``, or 1 where they are equal, kept a tensor: a
  division by it is a float32 division, where a Python scalar divisor
  may become a multiply by its reciprocal;
* ``trunc((fin - mn) / denom * max_val)`` as u8;
* NEVER_FILL (255) for NaN, -inf, 0 and values below float32's ``tiny``
  (subnormals), ALWAYS_FILL (0) for +inf.

Why the tolerance on the levels is 0: each step is a correctly rounded
IEEE float32 operation (subtract, divide, multiply, truncate; the min and
max folds are exact in any order), done in the same order as the program
does them, so the program's levels equal these bit for bit.  A quantiser
in another precision (float64, float16) or in another order (a multiply
by the reciprocal) rounds differently at quantisation boundaries and
moves some pixels by a level, which the comparison counts.

``labels(map, control=False)`` is ``reference/segmenting.py``'s
``labels(levels(map), control)``; ``seeds`` likewise.  This module
imports torch, NumPy and its sibling file, never the code under test."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

NEVER_FILL = 255
ALWAYS_FILL = 0
MAX_VAL = 254
TINY = float(np.finfo(np.float32).tiny)


def _segmenting():
    path = Path(__file__).resolve().parent / "segmenting.py"
    spec = importlib.util.spec_from_file_location("portbench_reference_segmenting_of_map", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


segmenting = _segmenting()


def levels(m, max_val: int = MAX_VAL, dtype=torch.float32) -> np.ndarray:
    """The u8 levels of the map ``m`` (any array-like).  ``dtype`` other
    than float32 gives a quantiser in another precision (the tests'
    planted fault)."""
    x = torch.as_tensor(np.asarray(m)).to("cpu", dtype)
    finite = torch.isfinite(x)
    fin = torch.where(finite, x, 0.0)
    zero = torch.zeros((), dtype=dtype)
    mn = torch.minimum(zero, fin.amin())
    mx = torch.maximum(zero, fin.amax())
    is_normal = finite & (x.abs() >= TINY)
    pos_inf = torch.isinf(x) & (x > 0)
    denom = torch.where(mx != mn, mx - mn, torch.ones((), dtype=dtype))
    scaled = torch.trunc((fin - mn) / denom * float(max_val)).to(torch.uint8)
    out = torch.where(is_normal, scaled, torch.full((), NEVER_FILL, dtype=torch.uint8))
    out = torch.where(pos_inf, torch.full((), ALWAYS_FILL, dtype=torch.uint8), out)
    return out.numpy()


def labels(m, control: bool = False, max_val: int = MAX_VAL) -> np.ndarray:
    """The label plane of the pre-processor then ``watershed_e2e``
    (segmenting, seeds from the levels); ``control=True``: the control's
    (the greatest label wins a tie)."""
    return segmenting.labels(levels(m, max_val), control=control)


def seeds(m, max_val: int = MAX_VAL) -> np.ndarray:
    """``(n, 2)`` seed coordinates of the map's levels, row-major."""
    return segmenting.seeds(levels(m, max_val))


def boundary_value(m, max_val: int = MAX_VAL):
    """A float32 value strictly inside the map's range whose level in
    float32 differs from its level in float64 under the map's ``mn`` and
    ``denom``: placed in the map, it makes a float64 quantiser differ from
    ``levels`` (the tests' witness that the comparison sees a quantiser of
    another precision).  None if no level boundary has one within 64
    ulps."""
    x = np.asarray(m, dtype=np.float32)
    fin = x[np.isfinite(x)]
    mn = np.float32(min(0.0, float(fin.min()))) if fin.size else np.float32(0)
    mx = np.float32(max(0.0, float(fin.max()))) if fin.size else np.float32(0)
    if mx == mn:
        return None

    def level(v, t):
        return np.trunc((t(v) - t(mn)) / (t(mx) - t(mn)) * t(max_val))

    for k in range(1, max_val):
        v = np.float32(float(mn) + k * (float(mx) - float(mn)) / max_val)
        for _ in range(64):
            if mn < v < mx and np.abs(v) >= TINY and level(v, np.float32) != level(v, np.float64):
                return v
            v = np.nextafter(v, np.float32(np.inf))
    return None
