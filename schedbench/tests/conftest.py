"""Settings of the benchmark's own tests (run from the repository root:
`python -m pytest schedbench/tests`)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    """cuda:0, or a skip where there is no card (decided here, not at
    import, so every worker collects the same tests)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
