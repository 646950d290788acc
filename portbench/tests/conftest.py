"""Shared pieces of the benchmark's tests: the repository's ``src`` and
root on the path, the ``card`` marker, and the fixture that skips a
card-only test where no CUDA card is visible (decided when the test runs,
never when a module is imported)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is visible")
