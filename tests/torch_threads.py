"""A module-scoped fixture that runs a port test module's torch ops on one
thread.

The port's tests run thousands of small tensor ops on the CPU.  Torch's
default intra-op pool, a thread a core in every pytest worker,
oversubscribes the cores when several workers run at once and slows such
tests several times over; one thread each runs them as fast alone and
far faster beside other workers.  A test module opts in with
``from torch_threads import one_torch_thread  # noqa: F401``; the thread
count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
