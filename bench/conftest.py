"""The benchmark's CPU tests run one intra-op thread each: the suite runs
several processes at once, and their thread pools would contend for the
same cores (a run of a cell on the CPU then takes a minute, not a
second)."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
