"""The table of peaks and the bytes a kernel must move.

Peak: one NVIDIA H100 SXM's 3.35 TB/s of HBM (NVIDIA's data sheet;
``chip_smoke.py``'s ``HBM_BYTES_PER_MS``).  Every kernel counted here is
bound by bytes against the 67 T integer operations a second that
``chip_smoke.py::bound`` also weighs, so a share is the bytes' time at the
peak over the device time.

Byte counts, frozen copies of ``chip_smoke.py``:

* relax call (``:1156``, ``px * (1 + 8 + 8)``): the u8 value plane read,
  the key and label planes read and written once, 17 B a pixel a launch;
* coarse round (``:1324``, ``2 * cells * 4``): the coarse int32 plane
  (``ceil(h / 2)`` rows of ``w``) read and written once, 8 B a cell.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def relax_bytes(h: int, w: int) -> int:
    return h * w * (1 + 8 + 8)


def coarse_cells(h: int, w: int) -> int:
    return ((h + 1) // 2) * w


def coarse_round_bytes(h: int, w: int) -> int:
    return 2 * coarse_cells(h, w) * 4


def share_pct(nbytes: float, device_s: float):
    """The bytes' time at the peak over the measured device time, in %;
    None when nothing was measured."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
