"""Sharded checkpoints over ``torch.distributed.checkpoint`` (counterpart of
the JAX package's Orbax backend, ``midi_vae_tpu/io/orbax_io.py``).

``--checkpoint-backend orbax`` writes a directory under the JAX package's
names (``checkpoint_latest.orbax``, ``best_model.orbax``) holding

- ``state/``: the train state's tensors, saved with
  ``torch.distributed.checkpoint`` (DCP). Every rank takes part and
  writes its part; a tensor every rank holds is written once;
- ``structure.pt``: the state's nesting and its non-tensor leaves (step,
  the optimizer's hyperparameters), each tensor named by its key in
  ``state/``;
- ``midi_vae_meta.json``: the payload's config and counters, as the JAX
  package's sidecar, plus ``"format": "torch-dcp"``.

The JAX package's semantics are kept: the new checkpoint is built in
``<path>.staging`` and swapped into place (the current one parked at
``<path>.old`` while a complete replacement exists; a load falls back to
``.old`` when ``<path>`` is missing), :class:`DCPAsyncWriter` keeps at
most one write in flight and swaps on the next ``save`` or ``wait``, and
:func:`is_orbax_checkpoint` recognises such a directory, and one the JAX
package's Orbax wrote (its sidecar has no ``"format"``), which
:func:`load_checkpoint_dcp` hands to ``io/orbax_read.py``: its OCDBT
store of zarr arrays is read with the port's own zstd, OCDBT and zarr
readers.

Over several ranks the checkpoint's collectives run on a gloo group of
their own (made on first use, on every rank), so an asynchronous write
never interleaves with the training's collectives.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

ORBAX_CHECKPOINT_LATEST = "checkpoint_latest.orbax"
ORBAX_BEST_MODEL = "best_model.orbax"
FORMAT = "torch-dcp"
_META_NAME = "midi_vae_meta.json"
_STRUCTURE_NAME = "structure.pt"
_TENSOR = "__dcp_tensor__"

_group_lock = threading.Lock()
_group_cache: list = [None, None]  # [the default group it was made over, the checkpoint group]


def _group():
    """The checkpoint's gloo group over the default group's ranks (None
    outside a process group), made once per default group: every rank
    reaches it at the same save or load, as ``new_group`` needs."""
    if not dist.is_initialized():
        return None
    world = dist.group.WORLD
    with _group_lock:
        if _group_cache[0] is not world:
            _group_cache[:] = [world, dist.new_group(backend="gloo")]
        return _group_cache[1]


def _leader() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)


def _flatten(tree, prefix: str, tensors: Dict[str, torch.Tensor]):
    """The tree with each tensor replaced by ``{_TENSOR: key}``, the tensor
    stored in ``tensors`` under ``key``."""
    if isinstance(tree, torch.Tensor):
        tensors[prefix] = tree
        return {_TENSOR: prefix}
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}/{k}", tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, f"{prefix}/{i}", tensors) for i, v in enumerate(tree))
    return tree


def _unflatten(tree, tensors: Dict[str, torch.Tensor]):
    if isinstance(tree, dict):
        if set(tree) == {_TENSOR}:
            return tensors[tree[_TENSOR]]
        return {k: _unflatten(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, tensors) for v in tree)
    return tree


def _jsonable(tree):
    if isinstance(tree, dict):
        return {k: _jsonable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jsonable(v) for v in tree]
    if isinstance(tree, np.integer):
        return int(tree)
    if isinstance(tree, np.floating):
        return float(tree)
    return tree


def _write(staging: str, state, meta: dict, group) -> None:
    """Every rank: the state's tensors into ``staging/state``; the leader:
    the structure and the sidecar."""
    import torch.distributed.checkpoint as dcp

    tensors: Dict[str, torch.Tensor] = {}
    structure = _flatten(state, "state", tensors)
    dcp.save(tensors, checkpoint_id=os.path.join(staging, "state"), process_group=group, no_dist=group is None)
    if _leader():
        torch.save(structure, os.path.join(staging, _STRUCTURE_NAME))
        with open(os.path.join(staging, _META_NAME), "w") as f:
            json.dump(_jsonable({**meta, "format": FORMAT}), f)


def _prepare_staging(path: str, group) -> str:
    staging = path + ".staging"
    if _leader():
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
    _barrier(group)  # no rank writes into a staging directory the leader has yet to clear
    return staging


def _swap_staging_into_place(path: str) -> None:
    """Leader: promote a complete ``path.staging`` to ``path`` (current →
    ``.old`` only while current is complete, staging → current, drop ``.old``)."""
    staging, old = path + ".staging", path + ".old"
    if os.path.exists(path):
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(path, old)
    os.rename(staging, path)
    shutil.rmtree(old, ignore_errors=True)


def save_checkpoint_dcp(checkpoint_path: str, state, **meta) -> None:
    """Save ``state`` (a state dict of tensors, dicts, lists and scalars) and
    the payload's ``meta`` as a checkpoint directory; every rank calls it."""
    path = os.path.abspath(checkpoint_path)
    group = _group()
    staging = _prepare_staging(path, group)
    _write(staging, state, meta, group)
    _barrier(group)
    if _leader():
        _swap_staging_into_place(path)


class DCPAsyncWriter:
    """Asynchronous sharded saves (``--async-checkpoint --checkpoint-backend
    orbax``): ``save`` copies the state to the CPU, hands the write to a
    thread and returns; the next ``save`` or ``wait`` joins it and (leader)
    swaps the finished checkpoint into place, so at most one write is in
    flight and a complete checkpoint always exists at ``path`` or
    ``path.old``. Every rank makes one and calls each method."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[str] = None

    def save(self, checkpoint_path: str, state, **meta) -> None:
        from midi_vae_tpu_torch.io.checkpoint import _to_cpu

        meta.pop("backend", None)  # the routing hint, not payload
        self.wait()
        path = os.path.abspath(checkpoint_path)
        group = _group()
        staging = _prepare_staging(path, group)
        host_state = _to_cpu(state)

        def _run():
            try:
                _write(staging, host_state, meta, group)
            except BaseException as e:  # raised again by the next save/wait
                self._error = e

        # not a daemon: interpreter shutdown waits for the last handed-off write
        self._thread = threading.Thread(target=_run, daemon=False)
        self._thread.start()
        self._pending = path

    def wait(self) -> None:
        """Block until the write in flight has landed on every rank; then
        the leader swaps it into place. Re-raises the write's error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error, self._pending = self._error, None, None
            raise err
        if self._pending is not None:
            path, self._pending = self._pending, None
            if _leader():
                _swap_staging_into_place(path)


def _resolve(checkpoint_path: str) -> Optional[str]:
    """The directory to load: ``path`` when complete, else the ``.old`` copy
    a crash inside the swap left, else None."""
    path = os.path.abspath(checkpoint_path)
    for candidate in (path, path + ".old"):
        if os.path.isdir(candidate) and os.path.isfile(os.path.join(candidate, _META_NAME)):
            return candidate
    return None


def is_orbax_checkpoint(checkpoint_path: str) -> bool:
    """Whether ``checkpoint_path`` (or its ``.old`` fallback) is a checkpoint
    directory of either package's ``orbax`` backend."""
    return _resolve(checkpoint_path) is not None


def load_checkpoint_dcp(checkpoint_path: str) -> Dict[str, Any]:
    """The payload of a checkpoint directory (tensors on the CPU); every rank
    of a process group calls it. A directory the JAX package's Orbax wrote
    is read by ``io/orbax_read.py`` (its flax state, ``"state_format":
    "flax"``)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    resolved = _resolve(checkpoint_path)
    if resolved is None:
        raise FileNotFoundError(f"no orbax-backend checkpoint at '{checkpoint_path}' (or its .old fallback)")
    if resolved != os.path.abspath(checkpoint_path):
        print(f"Recovering checkpoint from swap-window fallback '{resolved}'")
    with open(os.path.join(resolved, _META_NAME)) as f:
        payload: Dict[str, Any] = json.load(f)
    if payload.pop("format", None) != FORMAT:
        from midi_vae_tpu_torch.io.orbax_read import load_jax_orbax

        return load_jax_orbax(resolved)
    state_dir = os.path.join(resolved, "state")
    metadata = FileSystemReader(state_dir).read_metadata()
    tensors = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
               for k, m in metadata.state_dict_metadata.items()}
    group = _group()
    dcp.load(tensors, checkpoint_id=state_dir, process_group=group, no_dist=group is None)
    structure = torch.load(os.path.join(resolved, _STRUCTURE_NAME), map_location="cpu", weights_only=True)
    payload["state"] = _unflatten(structure, tensors)
    return payload


def copy_best_dir(checkpoint_path: str, best_path: str) -> str:
    """Leader: copy a checkpoint directory to ``best_path`` through a staging
    copy and the same swap, so a crash mid-copy leaves the old best whole."""
    staging = best_path + ".staging"
    if os.path.isdir(staging):
        shutil.rmtree(staging)
    shutil.copytree(checkpoint_path, staging)
    _swap_staging_into_place(os.path.abspath(best_path))
    return best_path
