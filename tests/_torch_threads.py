"""One intra-op thread budget for the port's CPU tests under pytest-xdist.

The suite runs in several worker processes at once (`-n 6`). Each
PyTorch process starts one intra-op thread a core by default, and six
such processes on one machine spend most of their time waiting on each
other: a training test of 12 s alone took 450 s so. Under xdist this
fixture gives each worker's tests the cores divided by the workers (at
least one) and restores the count after each test; in one process it
changes nothing. A test module applies it by importing it:

    from _torch_threads import torch_threads_per_worker  # noqa: F401
"""
from __future__ import annotations

import os

import pytest
import torch


@pytest.fixture(autouse=True)
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers <= 1:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
