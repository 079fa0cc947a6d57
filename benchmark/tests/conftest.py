"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``card`` that need a CUDA device (run them on the machine with the card:
``python -m pytest benchmark/tests -m card``). Whether a card is present is
decided inside the ``card`` fixture, never while a module is imported."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
