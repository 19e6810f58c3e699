"""Fixtures of the benchmark's own tests, and the ``gpu`` marker."""
import pytest

from bench.tests.support import copy_bench, shrink


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def one_thread():
    """Runs each test on one intra-op thread: the tests' models are small,
    and test workers sharing the CPU with a thread pool each slow every
    small op by orders of magnitude (a run's window then finishes no
    request)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark whose configurations are cut to CPU size
    by editing their files only: what a run does on the card, at a size a
    test can hold."""
    return shrink(copy_bench(tmp_path))


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import time."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
