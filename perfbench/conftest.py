"""pytest settings of the benchmark's own tests: the harness on the path,
the ``gpu`` marker, and a fixture that decides whether there is a card."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips with a reason where there is none"
    )


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's cells run only on the card")
    return torch.device("cuda", 0)
