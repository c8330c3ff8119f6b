"""Tests of the benchmark's own code.  ``chip`` marks a test that needs
the card; it skips inside the test (the ``card`` fixture) where there is
none, never while the module is imported."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (runs on the chip)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda", 0)
