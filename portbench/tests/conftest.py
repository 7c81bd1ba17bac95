"""The benchmark's CPU tests run tiny models: two threads a test process
keep them quick when several workers share the machine."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
