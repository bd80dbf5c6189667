"""The benchmark's own tests (run as ``python -m pytest benchmark/tests``
from the root of the repo).  Tests that need the card carry the ``cuda``
marker and skip inside the ``cuda_device`` fixture where there is none."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the benchmark measures the "
        "card only)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
