"""Per-level PNG rendering of the label image.

Counterpart of ``rustronomy_watershed_tpu.utils.plotting`` and the
reference's ``plots`` cargo feature (reference src/lib.rs:698-834 and
src/plotting/color_maps.rs): 1:1-pixel PNGs named ``ws_lvl{N}.png`` through
one of five colour maps (grey_scale, viridis, magma, plasma, inferno).

The 256-entry MAGMA / INFERNO / PLASMA / VIRIDIS tables are committed data
(``colormap_tables.npz``, a copy of the JAX package's), so rendering needs no
matplotlib.  A colour map keeps the reference's scalar signature
``cmap(count, min, max) -> (r, g, b)``, so users can pass their own to
``TransformBuilder.set_plot_colour_map``; the built-in maps render whole
images vectorised.

Reference quirks kept (clamped where the reference would panic): the
intensity index is ``(255*count + min) / max`` (src/lib.rs:777), and
``count <= min`` renders the NaN colour (black).
"""

from __future__ import annotations

import functools
import os
import struct
import zlib

import numpy as np

NAN_COL = (0, 0, 0)

_TABLES_NPZ = os.path.join(os.path.dirname(__file__), "colormap_tables.npz")


@functools.lru_cache(maxsize=None)
def _table(name: str) -> np.ndarray:
    """256x3 float RGB table in [0, 1]."""
    if name == "grey_scale":
        g = np.linspace(0.0, 1.0, 256)
        return np.stack([g, g, g], axis=1)
    with np.load(_TABLES_NPZ) as z:
        return z[name]


def _index(count, mn, mx) -> int:
    # (255*count + min) / max as an integer (src/lib.rs:761-762), clamped to
    # the table instead of panicking at 256.
    if mx == 0:
        return 0
    return int(min(255, max(0, (255.0 * float(count) + float(mn)) / float(mx))))


def _make_scalar_cmap(name: str):
    def cmap(count, mn, mx):
        if count <= mn:
            return NAN_COL
        c = _table(name)[_index(count, mn, mx)]
        return tuple(int(v * 255.999) for v in c)

    cmap.__name__ = name
    cmap._table_name = name  # the vectorised path's hint
    return cmap


grey_scale = _make_scalar_cmap("grey_scale")
viridis = _make_scalar_cmap("viridis")
magma = _make_scalar_cmap("magma")
plasma = _make_scalar_cmap("plasma")
inferno = _make_scalar_cmap("inferno")


def render_rgb(slice2d: np.ndarray, colour_map=viridis) -> np.ndarray:
    """(H, W, 3) uint8 rendering of a 2-D array through a colour map."""
    a = np.asarray(slice2d)
    mn, mx = float(a.min(initial=0)), float(a.max(initial=0))
    name = getattr(colour_map, "_table_name", None)
    if name is not None:
        if mx == 0:
            idx = np.zeros(a.shape, dtype=np.int64)
        else:
            idx = np.clip((255.0 * a.astype(np.float64) + mn) / mx, 0, 255).astype(np.int64)
        rgb = (_table(name)[idx] * 255.999).astype(np.uint8)
        rgb[a <= mn] = NAN_COL
        return rgb
    out = np.empty(a.shape + (3,), dtype=np.uint8)
    for (y, x), v in np.ndenumerate(a):
        out[y, x] = colour_map(v, mn, mx)
    return out


def plot_slice(slice2d: np.ndarray, file_name: str, colour_map=viridis) -> None:
    """Write a 1:1-pixel PNG of ``slice2d`` (src/lib.rs:713-749)."""
    _write_png(file_name, render_rgb(slice2d, colour_map))


def _write_png(file_name: str, rgb: np.ndarray) -> None:
    """matplotlib's ``imsave`` where matplotlib is installed (the JAX
    package's writer, so both packages write the same bytes), else a minimal
    PNG encoder on the standard library's zlib."""
    try:
        from matplotlib.image import imsave
    except ImportError:
        imsave = None
    if imsave is not None:
        imsave(file_name, rgb)
        return
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(file_name, "wb") as f:
        f.write(png)
