"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``chip`` that need a CUDA card and skip without one (run them on the card
with ``python3 -m pytest port_bench/tests -m chip``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: runs on the card only")
    return torch.device("cuda", 0)
