"""One torch thread for the port's end-to-end tests on the CPU.

These tests drive the plain twins step by step: thousands of small
tensor ops each. Under pytest-xdist several such modules share the
machine's cores, and torch's intra-op thread pool then spends far more
time waiting on its own threads than computing. A module that imports
:func:`one_torch_thread` runs its tests with one intra-op thread, which
runs each op inline, and restores the count afterwards."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
