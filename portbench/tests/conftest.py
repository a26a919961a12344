"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the
root of the repository. Tests marked ``card`` need a CUDA card; they skip
without one (decided inside the ``card`` fixture, never at import)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda", 0)
