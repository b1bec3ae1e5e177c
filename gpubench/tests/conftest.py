"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``cuda`` that need an NVIDIA GPU and skip without one."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

DATA = Path(__file__).resolve().parent / "data"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with the port's kernels; skips with the reason "
        "where there is none")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.fixture
def tiny():
    from gpubench import cells

    return cells.load_cell("tiny.tiny-s16", DATA)
