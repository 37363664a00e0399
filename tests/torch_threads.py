"""One intra-op thread for the port's CPU tests.

Their tensors are tiny, and PyTorch's default of one thread a core, in each
of the parallel test workers, spends most of a tiny operation synchronising
threads (an AR LM training step: 0.8 s with 8 threads, 0.06 s with one).
A test module takes this by importing the fixture::

    from tests.torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
