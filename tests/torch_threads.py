"""An autouse fixture for the port's CPU test files (not collected: no
``test_`` prefix): each test runs on one torch thread, the count restored
after. Their workloads are small ops, which slow by tens of times when
the suite's six workers share the machine's cores and each spreads every
op over all of them (OpenMP workers wait on each other)."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
