"""``ops.pre_process_jnp`` (the port's float32 device pre-processor) against
the JAX package's ``pre_process_jnp``, bit for bit, and the port's ``ops``
exports against the JAX package's.

On the golden_morph_v1 float field (``tools/gen_golden_morph.py``'s recipe
at 1024² before quantisation), the float32 path differs from the float64
``pre_process`` in 2 pixels at ``max_val`` 20 and in 9 at 254, by one
level each (float32 rounding at quantisation boundaries, JAX's documented
divergence); JAX's float32 variant gives the same pixels.
"""

import functools
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_fields import morph_field

from rustronomy_watershed_tpu import ops as j_ops
from rustronomy_watershed_tpu.ops.preprocess import pre_process_jnp as j_pre_process_jnp
from rustronomy_watershed_tpu_torch import ops
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.ops.preprocess import pre_process, pre_process_jnp

MAX_VALS = [1, 20, 254]
F32 = np.finfo(np.float32)


def _inputs():
    """Named float32 arrays: specials, zeros, subnormals, constants, signs."""
    rng = np.random.default_rng(5)
    mixed = (rng.normal(size=(40, 48)) * 300).astype(np.float32)
    flat = mixed.reshape(-1)
    flat[:6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, F32.smallest_subnormal]
    flat[6:12] = [F32.tiny, -F32.tiny, F32.tiny / 4, -F32.tiny / 2, F32.max, -F32.max / 2]
    sub = np.full((9, 11), F32.tiny / 8, np.float32)
    sub[::2, ::3] = -F32.tiny / 16
    sub[4, 4] = 1e-30
    return {
        "mixed specials": mixed,
        "subnormals": sub,
        "all zeros": np.zeros((5, 7), np.float32),
        "constant 3.5": np.full((6, 6), 3.5, np.float32),
        "constant -2": np.full((6, 6), -2.0, np.float32),
        "all negative": -np.abs(rng.normal(size=(17, 13))).astype(np.float32) - 0.5,
        "all nan": np.full((4, 4), np.nan, np.float32),
        "inf only": np.array([[np.inf, -np.inf], [np.nan, 1.0]], np.float32),
        "positive 1-D": (rng.random(257) * 1e6).astype(np.float32),
        "3-D": rng.normal(size=(3, 8, 5)).astype(np.float32),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("max_val", MAX_VALS)
@pytest.mark.parametrize("name", list(INPUTS))
def test_pre_process_jnp_equals_jax(name, max_val):
    x = INPUTS[name]
    got = pre_process_jnp(torch.from_numpy(x), max_val, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu" and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_pre_process_jnp(x, max_val)))


@pytest.mark.parametrize("dtype", [np.float64, np.int32, np.uint8, np.int64])
def test_pre_process_jnp_other_input_types_equal_jax(dtype):
    """Array-likes of any numeric dtype go through float32 as
    ``jnp.asarray(img, float32)`` takes them."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(23, 19)) * 1000).astype(dtype)
    want = np.asarray(j_pre_process_jnp(x))
    np.testing.assert_array_equal(pre_process_jnp(x, device="cpu").numpy(), want)
    np.testing.assert_array_equal(pre_process_jnp(x.tolist(), device="cpu").numpy(), want)


@functools.lru_cache(maxsize=1)
def _morph_float():
    """The golden_morph_v1 float field before quantisation."""
    return morph_field()


@pytest.mark.parametrize("max_val,n_diff", [(20, 2), (254, 9), (1, 0)])
def test_morph_float_field_against_jax_and_the_float64_path(max_val, n_diff):
    """Equal to JAX's float32 variant; against the float64 host path, the
    docstring's count of one-level differences."""
    sm = _morph_float()
    got = pre_process_jnp(sm, max_val, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(j_pre_process_jnp(sm, max_val)))
    host = pre_process(sm, max_val)
    diff = got != host
    assert int(diff.sum()) == n_diff
    assert np.abs(got.astype(int) - host)[diff].max(initial=0) <= 1


def test_pre_process_jnp_goes_to_the_card_by_default():
    """Without ``device=`` an array-like goes to the card, as ``jnp.asarray``
    puts it on the accelerator; a host without CUDA refuses."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without it")
    for img in (INPUTS["mixed specials"], torch.from_numpy(INPUTS["mixed specials"])):
        with pytest.raises(RuntimeError, match="cuda"):
            pre_process_jnp(img)


def test_ops_exports_equal_jax():
    assert ops.__all__ == j_ops.__all__
    assert ops.run_levels is run_levels_impl
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name


def test_importing_ops_builds_no_kernel():
    code = ("import sys; import rustronomy_watershed_tpu_torch.ops as o; "
            "from rustronomy_watershed_tpu_torch import _ext; "
            "assert _ext._lib is None and 'jax' not in sys.modules and len(o.__all__) == 17")
    subprocess.run([sys.executable, "-c", code], check=True)
