"""The in-process launcher: N ranks, one process per device.

:func:`spawn` starts ``world`` processes (start method ``spawn``), each of
which joins one group through a ``file://`` store in a temporary
directory (no TCP port to pick) on ``cuda:r``, or on the CPU over gloo,
and calls ``fn(rank, device, *args)``. It returns rank 0's return value,
handed back through a file. It never starts fewer ranks than asked for:
more CUDA ranks than visible GPUs raise before anything starts. CPU ranks
run one thread each. Ranks other than 0 print nothing.

``fn`` must be importable by the new processes (a module-level function):
the train CLI passes :func:`train_rank`, and tests pass functions of a
module that imports no JAX.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from midi_vae_tpu_torch.parallel.mesh import init_from_spawn


def check_device_count(world: int, device_type: str) -> None:
    """Raise when ``world`` CUDA ranks ask for more GPUs than are visible."""
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if world > have:
            raise ValueError(f"requested {world} devices, only {have} available")


def _worker(rank: int, world: int, device_type: str, store: str, result: str, timeout_s, fn: Callable,
            args: tuple) -> None:
    if rank:
        sys.stdout = open(os.devnull, "w")
    if device_type == "cpu":
        torch.set_num_threads(1)
    dev = init_from_spawn(rank, world, store, f"cuda:{rank}" if device_type == "cuda" else "cpu", timeout_s)
    try:
        out = fn(rank, dev, *args)
        if rank == 0:
            torch.save(out, result)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device_type: str, *args, timeout_s: Optional[float] = None):
    """Run ``fn(rank, device, *args)`` on ``world`` ranks; rank 0's result.
    ``timeout_s`` bounds each collective's wait (a rank that died leaves
    the others waiting otherwise)."""
    check_device_count(world, device_type)
    tmp = tempfile.mkdtemp(prefix="midi_vae_tpu_torch_ranks_")
    try:
        result = os.path.join(tmp, "result.pt")
        mp.start_processes(
            _worker, args=(world, device_type, os.path.join(tmp, "store"), result, timeout_s, fn, args),
            nprocs=world, start_method="spawn", join=True,
        )
        return torch.load(result, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_rank(rank: int, device: torch.device, config) -> dict:
    """One rank of ``train.loop.run``: its results without the train state,
    and the state as plain tensors (``state_dict``), for the caller to
    rebuild."""
    from midi_vae_tpu_torch.train.loop import run
    from midi_vae_tpu_torch.train.state import state_dict

    results = run(config, device=device)
    return {"results": results, "state_dict": state_dict(results.pop("state"))}
