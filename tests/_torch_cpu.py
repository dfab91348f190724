"""A fixture the port's CPU test files share: ``from _torch_cpu import
one_thread`` puts it in a module, where it applies to every test.

pytest's workers share the machine's cores. The tensors of these tests are
small, and torch's intra-op thread pool in each worker only has the
workers' threads wait on each other: with every core busy, a plain Jacobi
sweep on a few small matrices runs tens of times slower on the default
pool than on one thread.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread for the module's tests, then as before."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
