"""Torch CPU threads of the port's test modules.

The tier-1 suite runs in several pytest-xdist workers on one machine;
torch's default of one intra-op thread per core oversubscribes the cores
several times over, and OpenMP's spin-waiting then stalls the workers (a
three-step CPU trainer run took 165 s beside the other workers and 3.6 s
with two threads each, measured with `pytest -n 6 --dist loadfile`). Each
port test module imports `torch_threads`, an autouse module-scoped fixture
that sets two threads and restores the count after the module.
"""
import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)
