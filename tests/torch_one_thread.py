"""A module-scoped autouse fixture that runs a test module's torch work,
and the processes it starts, on one host thread: the port's parity
modules spawn ranks and bench processes beside the other modules that
``pytest -n`` runs at once, and threads past the cores spin against each
other.  Import the fixture into a test module to use it:

    from torch_one_thread import one_thread  # noqa: F401
"""

import os
from unittest import mock

import pytest
import torch

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mock.patch.dict(os.environ, {v: "1" for v in THREAD_VARS}):
            yield
    finally:
        torch.set_num_threads(n)
