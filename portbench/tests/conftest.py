"""CPU tests of the port's benchmark harness; the ``cuda`` tests run on a
card (``python -m pytest -q portbench/tests -m cuda`` there) and skip
elsewhere."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent), str(BENCH)]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
