"""Fixtures of the benchmark's CPU tests."""
import pytest

from .tiny import make_tiny_root


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks what a run does without a CUDA device")


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny runs gain nothing from intra-op threads, and the suite runs
    beside other workers' tests: one thread each."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
