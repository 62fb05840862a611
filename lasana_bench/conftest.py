"""The benchmark's CPU tests run the program's plain versions; a few
threads each keep them quick beside other test workers on the same
cores."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
