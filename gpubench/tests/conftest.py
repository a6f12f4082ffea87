"""The benchmark's own tests. Tests marked ``cuda`` need a card and
decide so inside the test (``needs_cuda``), never at import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def needs_cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
