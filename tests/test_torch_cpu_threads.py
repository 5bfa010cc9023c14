"""The port's CPU tests run PyTorch on one thread.  It holds no test: the
``test_torch_*`` files that run the port import its fixture, which applies to every test
of the importing file.

The tier-1 run puts several test processes on the host's cores at once.  PyTorch's CPU
thread pool in each of them (one thread per core by default) then makes the tests' many
small operations wait on one another: six processes solving the same small game at
once took 381 s each with eight threads and 24 s each with one.  On one thread the
reductions also keep one summation order whatever the host's core count.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
