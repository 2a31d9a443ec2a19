"""A fixture for the port's CPU workload tests: a module that imports
``two_torch_threads`` runs its tests with at most two torch threads.

Parallel test workers share the machine's cores. Torch's default of one
OpenMP thread per core oversubscribes them, and its busy-waiting threads
then run tiny workloads more than ten times slower.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
