"""The benchmark's tests: CPU tests of the yardstick and the harness, and
tests marked ``card`` that run only where a CUDA device is visible (they
decide in a fixture, never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 -m pytest vmbench/tests -m card)")
    return torch.device("cuda", 0)
