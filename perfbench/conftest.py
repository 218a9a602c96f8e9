"""The benchmark's tests.  Tests that need the card carry the ``card``
marker and ask for the ``card`` fixture, which skips them where
``torch.cuda.is_available()`` is false; run them on the card with

    python -m pytest -m card perfbench
"""

import sys
from pathlib import Path

import pytest

_SRC = str(Path(__file__).resolve().parent.parent / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: several test processes share the cores."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
