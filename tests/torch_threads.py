"""One torch thread for each port test module that imports ``one_torch_thread``.

Tier-1 runs the tests in 6 pytest-xdist workers, and torch starts one
intra-op thread per core in each of them: on an 8-core host 48 threads
contend for 8 cores, and the port's tests, whose tensors are small, spend
most of their time on that contention. The fixture runs a module's tests on
one torch thread and gives the worker its count back after the module's
last test, so other modules keep torch's default.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
