"""Input pre-processing: normalise any numeric array to u8 water levels.

Host (numpy, float64) copy of ``rustronomy_watershed_tpu.ops.preprocess.
pre_process``, which replicates the reference ``WatershedUtils::
pre_processor_with_max`` **code** behaviour (reference src/lib.rs:
1134-1173; SURVEY.md quirk Q4):

* ``is_normal`` values  -> ``trunc((x - min) / (max - min) * MAX)`` as u8
* ``+inf``              -> ``ALWAYS_FILL`` (0)
* ``NaN``, ``-inf``, exactly ``0.0`` and subnormals -> ``NEVER_FILL`` (255)
* ``min``/``max`` are folds seeded with 0 over *finite* values, so the
  normalisation range always contains 0.

``pre_process_jnp`` is the float32 device variant, the counterpart of the
JAX package's ``pre_process_jnp`` ("jnp" names JAX's variant; this one is
plain torch, on the card unless the caller passes ``device="cpu"``).  Its
float32 rounding can differ from
the float64 host path at quantisation boundaries, and its subnormal cutoff
is float32's: JAX's documented divergence, irrelevant for normal-range
astronomy data.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _ext
from ..constants import ALWAYS_FILL, NEVER_FILL, NORMAL_MAX

_F64_MIN_NORMAL = np.finfo(np.float64).tiny
_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def pre_process(img, max_val: int = NORMAL_MAX) -> np.ndarray:
    """Host (numpy, f64) pre-processor; any numeric dtype, any rank."""
    if not (ALWAYS_FILL < max_val < NEVER_FILL):
        raise ValueError(
            f"max_val must satisfy {ALWAYS_FILL} < max_val < {NEVER_FILL}, got {max_val}"
        )
    x = np.asarray(img, dtype=np.float64)
    finite = np.isfinite(x)
    fin = np.where(finite, x, 0.0)
    # Folds seeded with zero over finite values (src/lib.rs:1147-1156).
    mn = min(0.0, float(fin.min())) if fin.size else 0.0
    mx = max(0.0, float(fin.max())) if fin.size else 0.0

    is_normal = finite & (np.abs(x) >= _F64_MIN_NORMAL)
    pos_inf = np.isinf(x) & (x > 0)

    with np.errstate(invalid="ignore", divide="ignore"):
        normal = (fin - mn) / (mx - mn) if mx != mn else np.zeros_like(fin)
    scaled = np.trunc(normal * float(max_val)).astype(np.uint8)

    out = np.full(x.shape, NEVER_FILL, dtype=np.uint8)
    out[is_normal] = scaled[is_normal]
    out[pos_inf] = ALWAYS_FILL
    return out


def pre_process_jnp(img, max_val: int = NORMAL_MAX, device="cuda") -> torch.Tensor:
    """Device variant (float32 internals): ``img`` a tensor, or an
    array-like taken as ``torch.as_tensor`` takes it, moved to ``device``
    (the card by default; a CUDA device on a host without CUDA raises);
    returns a uint8 tensor there.  The steps and their order are those of JAX's
    ``pre_process_jnp`` (preprocess.py:57-74): finite mask, the folds seeded
    with 0, float32 ``tiny`` as the subnormal cutoff, ``trunc((fin - mn) /
    denom * max_val)``, then NEVER_FILL and ALWAYS_FILL.  ``denom`` stays a
    tensor on the device: CUDA divides by a host scalar as a multiply by its
    reciprocal, which rounds differently from the division."""
    x = torch.as_tensor(img).to(_ext.resolve_device(device), torch.float32)
    finite = torch.isfinite(x)
    fin = torch.where(finite, x, 0.0)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mn = torch.minimum(zero, fin.amin())
    mx = torch.maximum(zero, fin.amax())

    is_normal = finite & (x.abs() >= _F32_MIN_NORMAL)
    pos_inf = torch.isinf(x) & (x > 0)

    denom = torch.where(mx != mn, mx - mn, 1.0)
    scaled = torch.trunc((fin - mn) / denom * float(max_val)).to(torch.uint8)

    out = torch.where(is_normal, scaled, NEVER_FILL)
    return torch.where(pos_inf, ALWAYS_FILL, out)
