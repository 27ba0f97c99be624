"""The port's tests run on one intra-op torch thread. Every
``tests/test_torch_*.py`` of the port takes ``one_torch_thread`` with one
import (``test_torch_imports.py`` checks that each does); this module
imports only torch and pytest, so taking it loads nothing else."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's tests on one intra-op thread. The suite runs several
    xdist workers on one host's cores; torch's default of one thread a core
    in every worker oversubscribes them (spinning threads then wait on each
    other), and the tests' narrow models gain nothing from the threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
