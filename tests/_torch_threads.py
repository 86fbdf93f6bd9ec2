"""Shared by tests/test_torch_*.py: the port's side of a test module runs
on one torch thread.

The suite runs one test worker a core, and the port's side of these tests
is many small tensor ops: on a pool of threads a worker, every worker's
pool competes for the same cores, and the tests run several times slower.
Importing ``one_torch_thread`` into a test module makes it the module's
autouse fixture: one thread for the module, then the count restored."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
