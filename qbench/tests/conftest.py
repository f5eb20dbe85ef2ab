"""The benchmark's own tests: ``python -m pytest qbench/tests -q`` (CPU;
the tests marked ``card`` run on a CUDA card and skip elsewhere)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present: decided here, when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def cpu_device(monkeypatch):
    """The port's device set to the CPU for the test."""
    from qubism_torch.config import config

    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setenv("QUBISM_TORCH_DEVICE", "cpu")
    return "cpu"


@pytest.fixture
def root():
    return ROOT

