"""Atomic checkpoint I/O (counterpart of ``midi_vae_tpu/io/checkpoint.py``).

The payload is the JAX package's: ``state`` (``train/state.py``
``state_dict``: model, optimizer, step, ema_params), ``config``,
``epoch``, ``total_step``, ``n_samples_seen``, ``encoder_config``,
``transform_args``, ``best_epoch`` and extras such as ``best_metric``.
It is written with ``torch.save`` — plain tensors, dicts and scalars,
every tensor moved to the CPU — to ``checkpoint_latest.pt``, through a
``.tmp.``-prefixed file renamed into place, so the latest file is always
complete. ``best_model.pt`` is a copy of it.

Loading a JAX package checkpoint (flax msgpack) and the Orbax backend
are not ported (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import os
import shutil
import threading
import warnings
from typing import Any, Dict, Iterable, Optional

import torch

from midi_vae_tpu_torch.parallel.mesh import is_leader

CHECKPOINT_LATEST = "checkpoint_latest.pt"
BEST_MODEL = "best_model.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(
    checkpoint_path: str,
    state: Dict[str, Any],
    *,
    config: Optional[Dict[str, Any]] = None,
    epoch: int = 0,
    total_step: int = 0,
    n_samples_seen: int = 0,
    encoder_config: Optional[Dict[str, Any]] = None,
    transform_args: Optional[Dict[str, Any]] = None,
    best_epoch: int = 0,
    **extra,
) -> None:
    """Write a checkpoint atomically; ``state`` is a state dict of plain
    tensors (``train.state.state_dict``), copied to the CPU here unless it
    already is. Rank 0 of a data-parallel run writes; the other ranks
    return at once."""
    if not is_leader():
        return
    os.makedirs(os.path.dirname(os.path.abspath(checkpoint_path)), exist_ok=True)
    payload = {
        "state": _to_cpu(state),
        "config": config or {},
        "epoch": epoch,
        "total_step": total_step,
        "n_samples_seen": n_samples_seen,
        "encoder_config": encoder_config or {},
        "transform_args": transform_args or {},
        "best_epoch": best_epoch,
        **extra,
    }
    head, tail = os.path.split(checkpoint_path)
    tmp_path = os.path.join(head, ".tmp." + tail)
    torch.save(payload, tmp_path)
    os.rename(tmp_path, checkpoint_path)


def load_checkpoint(checkpoint_path: str) -> Dict[str, Any]:
    """Read a checkpoint written by :func:`save_checkpoint` (tensors on the CPU)."""
    if checkpoint_path.endswith(".msgpack") or os.path.isdir(checkpoint_path):
        raise NotImplementedError(
            f"{checkpoint_path}: JAX package checkpoints (msgpack, Orbax) do not load in the "
            "PyTorch package yet (ROADMAP Queue 1 item 10)"
        )
    return torch.load(checkpoint_path, map_location="cpu", weights_only=True)


class AsyncCheckpointWriter:
    """Checkpoint writes on a background thread: ``save`` takes a CPU copy of
    the state (so training can go on updating the live tensors), hands the
    write to a thread and returns; a new save first waits for the previous
    one, so at most one write is in flight. The thread is not a daemon:
    interpreter shutdown waits for the last handed-off write."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, checkpoint_path: str, state, **kwargs) -> None:
        self.wait()
        host_state = _to_cpu(state)

        def _write():
            try:
                save_checkpoint(checkpoint_path, host_state, **kwargs)
            except BaseException as e:  # raised again by the next save/wait
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight (if any) lands; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def copy_best(checkpoint_path: str, best_path: Optional[str] = None) -> str:
    """Copy the latest checkpoint to the best-model file (temp file, then
    replace); rank 0 of a data-parallel run copies, the others only return
    the path."""
    if best_path is None:
        best_path = os.path.join(os.path.dirname(checkpoint_path), BEST_MODEL)
    if not is_leader():
        return best_path
    shutil.copyfile(checkpoint_path, best_path + ".tmp")
    os.replace(best_path + ".tmp", best_path)
    return best_path


# keys never restored from a checkpoint: this run's identity and execution knobs
NON_RESTORED_KEYS = frozenset(
    {
        "resume",
        "gpu",
        "global_rank",
        "local_rank",
        "cpu_workers",
        "checkpoint_path",
        "async_checkpoint",
        "checkpoint_backend",
        "profile_dir",
        "profile_epochs",
        "data_placement",
        "scan_steps",
        "prefetch",
    }
)


def restore_config(
    config: Dict[str, Any],
    checkpoint_config: Dict[str, Any],
    skip_keys: Iterable[str] = NON_RESTORED_KEYS,
) -> Dict[str, Any]:
    """Backfill the live config's ``None`` values from a checkpoint's config;
    values that differ keep the live one, with a warning."""
    merged = dict(config)
    skip = set(skip_keys)
    for key, ckpt_value in checkpoint_config.items():
        if key in skip or ckpt_value is None:
            continue
        if merged.get(key) is None:
            merged[key] = ckpt_value
        elif merged[key] != ckpt_value:
            warnings.warn(
                f"config value for {key} differs from checkpoint: {merged[key]} (ours) vs {ckpt_value} (checkpoint)",
                UserWarning,
                stacklevel=2,
            )
    return merged
