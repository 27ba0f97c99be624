"""Tests of the port's benchmark harness. They run on the CPU at small
sizes; a test marked ``card`` needs a CUDA card and skips without one
(run them on the card with ``python -m pytest bench_cuda/tests -q -m card``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test on a machine without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


@pytest.fixture
def small():
    """(config, workload) of a cell cut to CPU size: narrow widths, a small
    batch and corpus."""
    import json

    def make(cell: str, dtype: str = None):
        wl = json.load(open(os.path.join(ROOT, f"bench_cuda/workloads/{cell}.json")))
        cfg = json.load(open(os.path.join(ROOT, f"bench_cuda/configs/{wl['config']}.json")))
        cfg["train"]["hidden_dims"] = [8, 8, 16, 16]
        if dtype:
            cfg["train"]["dtype"] = dtype
        wl["traffic"].update(batch=16, corpus=64, trace_steps=2)
        return cfg, wl

    return make

