"""Shared fixtures of the benchmark's tests.

Tests that need an NVIDIA card carry the ``card`` marker and take the
``card`` fixture, which skips them where there is none; the decision is
made when the test runs, never when a module is imported. Run them on the
card with ``python3 -m pytest benchmark/tests -m card``.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")
