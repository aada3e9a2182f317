"""The port's synthetic fields (``rustronomy_watershed_tpu_torch.utils.
fields``, a copy of the JAX package's) against the JAX package's, bit for
bit, and the golden ``golden_morph_v1.npz`` input rebuilt from them by the
recipe of ``tools/gen_golden_morph.py:34-52``."""

import os

import numpy as np
import pytest
from torch_fields import morph_field

from rustronomy_watershed_tpu.utils import fields as j_fields
from rustronomy_watershed_tpu_torch.models import WatershedUtils
from rustronomy_watershed_tpu_torch.utils import fields

SEEDS = [0, 7]
SHAPES = [(48, 64), (33, 17)]


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,kw", [("uniform_field", {}), ("uniform_field", {"hi": 20}),
                                     ("poisson_field", {}), ("poisson_field", {"lam": 3.5}),
                                     ("gaussian_random_field", {}), ("gaussian_random_field", {"power": -2.0})])
def test_generators_equal_jax(name, kw, seed, shape):
    _same(getattr(fields, name)(shape, seed=seed, **kw), getattr(j_fields, name)(shape, seed=seed, **kw))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_masks_and_smoothing_equal_jax(seed, shape):
    base = j_fields.gaussian_random_field(shape, seed=seed)
    _same(fields.nan_masked_field(base, frac=0.2, seed=seed), j_fields.nan_masked_field(base, frac=0.2, seed=seed))
    _same(fields.smooth(base, fwhm=3.0), j_fields.smooth(base, fwhm=3.0))
    _same(fields.blob_mask(shape, frac=0.15, n_blobs=3, seed=seed), j_fields.blob_mask(shape, frac=0.15, n_blobs=3, seed=seed))


def test_golden_morph_input_rebuilt_bit_for_bit():
    want = np.load(os.path.join(os.path.dirname(__file__), "golden", "golden_morph_v1.npz"))["img"]
    _same(WatershedUtils().pre_processor_with_max(morph_field(), 20), want)


def test_load_fits_slice_without_data_path(monkeypatch, tmp_path):
    """None without ``WSRS_DATA_PATH``, and None where it names a directory
    with no FITS file (astropy or not)."""
    monkeypatch.delenv("WSRS_DATA_PATH", raising=False)
    assert fields.load_fits_slice() is None and j_fields.load_fits_slice() is None
    monkeypatch.setenv("WSRS_DATA_PATH", str(tmp_path))
    assert fields.load_fits_slice() is None and j_fields.load_fits_slice() is None
