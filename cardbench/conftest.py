"""Tests of the benchmark (cardbench/tests/). Run them from the checkout
root with `python -m pytest cardbench/tests -q`: on the CPU the tests
marked `card` skip; on a machine with a CUDA device they run."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
