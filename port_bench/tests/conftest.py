"""Test settings for the benchmark's own tests: one torch thread, and the
``cuda`` marker of the tests that need a card (they skip without one).

    python -m pytest port_bench/tests -q
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
