"""A module-scoped fixture that runs a test file's PyTorch ops on one
thread.

The tier-1 run spreads files over several pytest-xdist workers on one
host; each worker's default intra-op pool is as wide as the host, so the
small matmuls of the port's emulations and reference comparisons spend
their time waiting on each other's threads.  A file that does
``from torch_threads import one_torch_thread`` runs on one thread and
restores the width it found when it ends.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    width = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(width)
