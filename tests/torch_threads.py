"""A fixture shared by the port's CPU tests (``tests/test_torch_*.py``),
which import it by name.

The suite runs test files in several worker processes at once, and
PyTorch's default of one intra-op thread per core then oversubscribes the
machine: each worker's small ops wait on threads that other workers hold
(measured: a registration that takes 6 s alone took 180 s beside five
other workers).  Tests that import this fixture run with one intra-op
thread.  It is module-scoped, so that it also covers the module-scoped
fixtures that build a file's reference results (an autouse fixture is set
up before the other fixtures of its scope; a function-scoped one would
come after them)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
