"""Synthetic astronomy-like test fields.

A copy of ``rustronomy_watershed_tpu.utils.fields`` (the port imports
nothing of the JAX package).  The reference's integration tests run on uniform random fields, Poisson
fields, Gaussian random fields and real CGPS FITS slices located via the
``WSRS_DATA_PATH`` env var (reference tests/integration.rs:36-48,
:122-602).  This module generates the synthetic equivalents (no external
data needed) and loads FITS cubes when astropy is available, preserving the
``WSRS_DATA_PATH`` convention.
"""

from __future__ import annotations

import os

import numpy as np


def uniform_field(shape=(1000, 1000), hi: int = 254, seed: int = 0) -> np.ndarray:
    """Uniform random u8 field in [0, hi) (integration.rs:122-183)."""
    return np.random.default_rng(seed).integers(0, hi, size=shape).astype(np.uint8)


def poisson_field(shape=(1000, 1000), lam: float = 30.0, seed: int = 0) -> np.ndarray:
    """Poisson-distributed counts field as f64 (integration.rs:187-250)."""
    return np.random.default_rng(seed).poisson(lam, size=shape).astype(np.float64)


def gaussian_random_field(
    shape=(512, 512), power: float = -2.5, seed: int = 0
) -> np.ndarray:
    """Gaussian random field with a power-law spectrum |k|^power, f64
    (integration.rs:432-513 uses a GRF FITS fixture)."""
    rng = np.random.default_rng(seed)
    ky = np.fft.fftfreq(shape[0])[:, None]
    kx = np.fft.fftfreq(shape[1])[None, :]
    k = np.sqrt(ky**2 + kx**2)
    k[0, 0] = 1.0
    amplitude = k ** (power / 2.0)
    amplitude[0, 0] = 0.0
    phases = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    field = np.fft.ifft2(amplitude * phases).real
    return (field - field.mean()) / (field.std() + 1e-12)


def nan_masked_field(base: np.ndarray, frac: float = 0.3, seed: int = 0) -> np.ndarray:
    """Blank out a border-heavy fraction with NaNs, like the NaN-heavy CGPS
    slice 0 (integration.rs:343-428)."""
    out = np.asarray(base, dtype=np.float64).copy()
    rng = np.random.default_rng(seed)
    mask = rng.random(out.shape) < frac
    # concentrate some NaNs at the edges, as in real mosaics
    k = max(1, out.shape[0] // 8)
    mask[:k, :] = True
    mask[:, -k:] = True
    out[mask] = np.nan
    return out


def smooth(base: np.ndarray, fwhm: float) -> np.ndarray:
    """Gaussian-smooth a 2-D field by FFT convolution (periodic boundary).

    The reference's smoothed-CGPS integration case
    (reference tests/integration.rs:517-602) runs the transform on a
    beam-convolved real map — plateau-heavy after u8 quantisation, the
    regime where ring-order (Q3) and tie-break bugs hide.  ``fwhm`` is the
    kernel full width at half maximum in pixels."""
    base = np.asarray(base, dtype=np.float64)
    sigma = float(fwhm) / 2.3548200450309493  # FWHM -> sigma
    ky = np.fft.fftfreq(base.shape[0])[:, None]
    kx = np.fft.fftfreq(base.shape[1])[None, :]
    # FT of a unit-integral Gaussian: exp(-2 pi^2 sigma^2 k^2)
    kernel = np.exp(-2.0 * np.pi**2 * sigma**2 * (ky**2 + kx**2))
    return np.fft.ifft2(np.fft.fft2(base) * kernel).real


def blob_mask(
    shape, frac: float = 0.1, n_blobs: int = 8, seed: int = 0
) -> np.ndarray:
    """Boolean mask of ~``n_blobs`` random ellipses whose union covers
    ~``frac`` of the area — the coverage-boundary NaN morphology of real
    CGPS-like mosaics (vs salt-and-pepper bad pixels).  Mirrors bench.py's
    BENCH_NANSHAPE=blobs construction."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros(shape, dtype=bool)
    r_mean = np.sqrt(h * w * frac / (n_blobs * np.pi))
    for _ in range(n_blobs):
        cy = rng.integers(0, h)
        cx = rng.integers(0, w)
        ry, rx = rng.uniform(0.5, 1.5, 2) * r_mean
        mask |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
    return mask


def load_fits_slice(index: int = 120, env: str = "WSRS_DATA_PATH"):
    """Load a 2-D slice from the CGPS FITS cube if astropy + the reference's
    WSRS_DATA_PATH dataset are available; returns None otherwise."""
    path = os.environ.get(env)
    if not path:
        return None
    try:
        from astropy.io import fits  # optional dependency, absent -> None
    except Exception:
        return None
    candidates = [
        os.path.join(path, n)
        for n in os.listdir(path)
        if n.lower().endswith((".fits", ".fit"))
    ]
    if not candidates:
        return None
    with fits.open(candidates[0]) as hdul:
        data = np.asarray(hdul[0].data, dtype=np.float64)
    if data.ndim == 3:
        data = data[min(index, data.shape[0] - 1)]
    return data
