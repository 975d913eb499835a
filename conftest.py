"""Test settings shared by every test directory of the repository."""

import pytest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread(request):
    """Run each test module of the PyTorch port (``test_torch_*.py``) at one
    torch intra-op thread, and give the module's neighbours their count back.

    The suite runs in several xdist workers at once (``-n 6``), and at torch's
    default every worker starts one intra-op thread per core: together they
    oversubscribe the cores many times over, while the port's small CPU
    tensors gain nothing from threads.  Child interpreters a test starts are
    not reached from here; they get ``OMP_NUM_THREADS=1`` in their own
    environment.  Other modules (the JAX reference tests, the benchmark's)
    keep torch's default, and torch is imported only for a port module.
    """
    if not request.path.name.startswith("test_torch_"):
        yield
        return
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
