"""Each test process keeps to two CPU threads, so that several pytest
workers share the machine's cores without thrashing."""

import pytest


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch
    torch.set_num_threads(2)
