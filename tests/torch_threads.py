"""One intra-op torch thread for the port's eager CPU tests.

The port's CPU tests run loops of small eager torch ops. Under
`pytest -n 6` every worker would start a full intra-op thread pool, and six
pools on one machine's cores spend most of their time waiting on each other
(13x the CPU time of one thread for the same work). A test module imports
`one_torch_thread` to run on one thread and restore the old count after:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
