"""Bounded liveness probe of the GPU (counterpart of
``midi_vae_tpu/core/backend_check.py``).

A wedged driver or a card that has fallen off the bus can make a
process's first CUDA call hang with no timeout, and a hung CUDA call
cannot be cancelled in-process. A server that touches the device at
start would then sit without an error and without a listening socket.
:func:`backend_alive` runs a 1024² matmul on ``cuda`` in a subprocess
under a deadline, with retries, so "slow" and "gone" can be told apart
before anything binds.
"""

from __future__ import annotations

import subprocess
import sys

_PROBE = (
    "import torch; a = torch.ones((1024, 1024), device='cuda'); "
    "assert float((a @ a)[0, 0]) == 1024.0; print('ok')"
)


def backend_alive(timeout_s: float = 300.0, attempts: int = 3, verbose: bool = True) -> bool:
    """True once the probe's matmul completes within the deadline."""
    for attempt in range(1, attempts + 1):
        try:
            proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=timeout_s)
            if proc.returncode == 0:
                return True
        except subprocess.TimeoutExpired:
            pass
        if verbose:
            print(f"backend pre-flight attempt {attempt}/{attempts} failed", file=sys.stderr)
    return False
