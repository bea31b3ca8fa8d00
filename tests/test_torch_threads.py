"""One intra-op thread for torch in the port's CPU tests.

Tier-1 runs its files on several pytest workers at once, each importing
torch, whose intra-op thread pool is sized to every core of the machine:
the workers' pools together oversubscribe the cores, and the port's
plain versions (torch ops) ran markedly slower in the suite than with
one thread a worker. Their bits do not depend on the thread count: they
are held to the JAX package bit for bit either way. Every
tests/test_torch_*.py imports `one_torch_thread`, an autouse fixture of
its module, which sets one thread for the module's tests and restores
the count after them.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_module_runs_one_torch_thread():
    assert torch.get_num_threads() == 1
