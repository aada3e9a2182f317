"""Test configuration: run everything on a virtual 8-device CPU mesh so
multi-chip sharding paths are exercised without TPU hardware (the JAX
"multi-node without a cluster" trick)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the ambient env may pin the TPU
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# jax is already imported by a pytest plugin at this point and has captured
# JAX_PLATFORMS from the ambient env; override through the config API (the
# backend itself is not initialized until the first jax.devices() call).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: runs a CUDA kernel on the card; skips on hosts without CUDA",
    )
    config.addinivalue_line("markers", "slow: a long test that Tier-1 leaves out (-m 'not slow')")
