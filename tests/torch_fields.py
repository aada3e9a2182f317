"""Label planes shared by the port's tests and ``chip_smoke.py``.  NumPy only:
no JAX, no torch (``morph_field`` imports the port's ``utils.fields`` when
it is called)."""

import numpy as np


def serpentine(h=48, w=48):
    """tests/test_merge_fast.py:338: a corridor of full even rows joined
    alternately at the ends, distinct labels along the way, the minimum deep
    inside: the component-min tails take many rounds on it."""
    lab = np.zeros((h, w), np.int32)
    nxt = 1000
    for r in range(2, h - 2, 2):
        lab[r, 2 : w - 2] = nxt
        nxt += 7
        if r + 2 < h - 2:
            lab[r + 1, 2 if (r // 2) % 2 == 0 else w - 3] = nxt
            nxt += 3
    lab[h - 4, w // 2] = 5
    return lab


def seed_lattice(shape, seed=0):
    """A u8 image with a strict maximum at every (odd, odd) pixel (values
    1..255 on a field of 0): about h*w/4 seeds, the densest seed plane."""
    img = np.zeros(shape, np.uint8)
    img[1::2, 1::2] = np.random.default_rng(seed).integers(1, 256, img[1::2, 1::2].shape)
    return img


def cone_lattice(shape, spacing=8):
    """A u8 image of square cones on a ``spacing`` lattice: a strict maximum
    (200) at each cone's apex, 10 less per ring (Chebyshev distance).  Every
    non-seed pixel's best claim passes an apex ring at 190, so the packed
    key's level is 190 everywhere and the relax fixed point is reached
    within about ``spacing`` sweeps: a first relax call of 12 or more
    steps certifies it at any size."""
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    half = spacing // 2
    dist = np.maximum(np.abs(yy % spacing - half), np.abs(xx % spacing - half))
    return (200 - 10 * dist).astype(np.uint8)


def plateau(shape, seed=0):
    """A u8 image of values 0..3: wide plateaus, few strict maxima."""
    return np.random.default_rng(seed).integers(0, 4, shape).astype(np.uint8)


def poisson_u8(shape, lam=30.0, seed=0):
    """The JAX package's Poisson counts field (utils/fields.py:23, the same
    draw) as a u8 image: values clipped to 0..254, a narrow range around
    ``lam``."""
    return np.clip(np.random.default_rng(seed).poisson(lam, size=shape), 0, 254).astype(np.uint8)


def corridor(h=41, w=38, lvl=5):
    """A u8 image of NEVER_FILL with a one-pixel corridor of value ``lvl``
    snaking through full odd rows: seeded at (1, 1), its plateau ring index
    runs to about h * w / 2, past a narrowed d field (chip_smoke.py phase
    4's 7-bit case)."""
    img = np.full((h, w), 255, np.uint8)
    for i, y in enumerate(range(1, h - 1, 2)):
        img[y, 1 : w - 1] = lvl
        if y + 2 < h - 1:
            img[y + 1, w - 2 if i % 2 == 0 else 1] = lvl
    return img


MORPH_SEED = 20260820


def morph_field(shape=(1024, 1024), seed=MORPH_SEED):
    """``tools/gen_golden_morph.py``'s ``build_field`` before quantisation,
    on the port's ``utils.fields``: a smoothed Gaussian random field with
    per-pixel noise of 2% of its range, shifted positive, NaN in blobs over
    12% of the plane.  ``golden_morph_v1.npz["img"]`` is this field at
    1024² through ``pre_processor_with_max(., 20)``."""
    from rustronomy_watershed_tpu_torch.utils import fields

    base = fields.gaussian_random_field(shape, power=-2.0, seed=seed)
    sm = fields.smooth(base, fwhm=24.0)
    rng = np.random.default_rng(seed + 2)
    sm = sm + 0.02 * (sm.max() - sm.min()) * rng.standard_normal(shape)
    sm = sm - sm.min() + 0.05 * (sm.max() - sm.min())
    sm[fields.blob_mask(shape, frac=0.12, n_blobs=8, seed=seed + 1)] = np.nan
    return sm
