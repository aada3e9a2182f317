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
"""

from __future__ import annotations

import numpy as np

from ..constants import ALWAYS_FILL, NEVER_FILL, NORMAL_MAX

_F64_MIN_NORMAL = np.finfo(np.float64).tiny


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
