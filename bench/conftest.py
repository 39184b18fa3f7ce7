"""The bench's own tests (``bench/tests``), run apart from the repository's:

    python -m pytest -q bench/tests            # on the CPU; card tests skip
    python -m pytest -q -m card bench/tests    # on a machine with the card

Tests marked ``card`` take the ``card`` fixture, which skips them where
there is no CUDA device.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); this machine has none")
