"""Shared test fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches
run on the single real CPU device; only the dry-run subprocess tests spawn
interpreters with forced device counts."""
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself when "
        "torch.cuda.is_available() is False")
