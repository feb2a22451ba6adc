"""Tests of the benchmark (python -m pytest benchmark/tests).  They run on
the CPU at small sizes; tests marked `gpu` need a CUDA device and skip
without one (decided in the `cuda` fixture, never at import)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's kernels); skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
