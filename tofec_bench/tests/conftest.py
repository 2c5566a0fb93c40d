"""The benchmark's tests: its harness at CPU sizes, and one card test."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; the test skips, with its reason, where none is present")


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, never
    while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def small(tmp_path):
    from tofec_bench.tests.small import small_root

    return small_root(tmp_path)
