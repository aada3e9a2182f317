"""A beam-smoothed sky map: a Gaussian random field with the power
spectrum ``|k| ** power``, convolved with a Gaussian beam of FWHM
``fwhm_px`` pixels, returned as a float32 map.  A frozen copy of the
recipe of ``rustronomy_watershed_tpu_torch/utils/fields.py``
(``gaussian_random_field`` then ``smooth``; upstream's GRF fixture and
beam-smoothed CGPS map, tests/integration.rs:432-602), drawn on the
generator's device with ``torch.fft`` in float64: the phases' real and
imaginary parts are two ``randn`` planes from ``gen``, the field is
normalised to zero mean and unit (population) deviation, then smoothed
by the beam's transfer function with periodic boundaries.

Traffic keys (``field``): ``power`` (the spectral index, e.g. -3.0) and
``fwhm_px``."""

import math

import torch

FWHM_TO_SIGMA = 2.3548200450309493


def make(shape, field, gen):
    h, w = shape
    dev = gen.device
    f64 = dict(dtype=torch.float64, device=dev)
    ky = torch.fft.fftfreq(h, **f64)[:, None]
    kx = torch.fft.fftfreq(w, **f64)[None, :]
    k2 = ky * ky + kx * kx
    k = torch.sqrt(k2)
    k[0, 0] = 1.0
    amp = k ** (float(field["power"]) / 2.0)
    amp[0, 0] = 0.0
    re = torch.randn(shape, generator=gen, **f64)
    im = torch.randn(shape, generator=gen, **f64)
    grf = torch.fft.ifft2(torch.complex(re, im) * amp).real
    grf = (grf - grf.mean()) / (grf.std(correction=0) + 1e-12)
    sigma = float(field["fwhm_px"]) / FWHM_TO_SIGMA
    beam = torch.exp(-2.0 * math.pi**2 * sigma**2 * k2)
    return torch.fft.ifft2(torch.fft.fft2(grf) * beam).real.to(torch.float32)
