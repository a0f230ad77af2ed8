"""CPU tests of the benchmark (``python -m pytest tsdb_bench/tests``).
Tests that need a CUDA card carry the ``card`` marker, decide inside the
test whether there is one, and skip without it."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a host without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")
