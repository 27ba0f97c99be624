"""Atomic checkpoint I/O (counterpart of ``midi_vae_tpu/io/checkpoint.py``).

The payload is the JAX package's: ``state`` (``train/state.py``
``state_dict``: model, optimizer, step, ema_params), ``config``,
``epoch``, ``total_step``, ``n_samples_seen``, ``encoder_config``,
``transform_args``, ``best_epoch`` and extras such as ``best_metric``.
It is written with ``torch.save`` — plain tensors, dicts and scalars,
every tensor moved to the CPU — to ``checkpoint_latest.pt``, through a
``.tmp.``-prefixed file renamed into place, so the latest file is always
complete. ``best_model.pt`` is a copy of it. That is the default backend
(``--checkpoint-backend msgpack``, named after the JAX package's file
format). ``--checkpoint-backend orbax`` writes a sharded directory
instead (``io/dcp_io.py``: ``torch.distributed.checkpoint``, every rank
writing its part), ``checkpoint_latest.orbax`` and ``best_model.orbax``.

:func:`load_checkpoint` reads all four kinds: the port's files, the
port's directories, and the JAX package's ``.msgpack`` checkpoints
(``io/flax_msgpack.py``) and Orbax directories (``io/orbax_read.py``). A JAX payload keeps its flax ``state``
(``params``, ``batch_stats``, ``opt_state``, ``step``, ``ema_params``)
and is marked ``"state_format": "flax"``; :func:`model_weights` maps it
onto a model of the port (``interop/from_jax.py``).
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
FLAX_STATE = "flax"


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
    backend: str = "msgpack",
    **extra,
) -> None:
    """Write a checkpoint atomically; ``state`` is a state dict of plain
    tensors (``train.state.state_dict``). The default backend copies it to
    the CPU and rank 0 of a data-parallel run writes one file (the other
    ranks return at once); ``backend="orbax"`` writes a sharded directory
    to which every rank contributes (``io/dcp_io.py``), so every rank calls it."""
    meta = {
        "config": config or {},
        "epoch": epoch,
        "total_step": total_step,
        "n_samples_seen": n_samples_seen,
        "encoder_config": encoder_config or {},
        "transform_args": transform_args or {},
        "best_epoch": best_epoch,
        **extra,
    }
    if backend == "orbax":
        from midi_vae_tpu_torch.io.dcp_io import save_checkpoint_dcp

        save_checkpoint_dcp(checkpoint_path, state, **meta)
        return
    if not is_leader():
        return
    os.makedirs(os.path.dirname(os.path.abspath(checkpoint_path)), exist_ok=True)
    payload = {"state": _to_cpu(state), **meta}
    head, tail = os.path.split(checkpoint_path)
    tmp_path = os.path.join(head, ".tmp." + tail)
    torch.save(payload, tmp_path)
    os.rename(tmp_path, checkpoint_path)


def load_checkpoint(checkpoint_path: str) -> Dict[str, Any]:
    """Read a checkpoint (tensors on the CPU): a file or directory of
    :func:`save_checkpoint`, or a JAX package ``.msgpack`` file or Orbax
    directory (its flax state kept, ``"state_format": "flax"``). A
    directory is read by every rank of a process group together."""
    from midi_vae_tpu_torch.io.dcp_io import is_orbax_checkpoint, load_checkpoint_dcp

    if is_orbax_checkpoint(checkpoint_path):
        return load_checkpoint_dcp(checkpoint_path)
    if checkpoint_path.endswith(".msgpack"):
        from midi_vae_tpu_torch.io.flax_msgpack import load

        payload = load(checkpoint_path)
        if not isinstance(payload, dict) or not isinstance(payload.get("state"), dict):
            raise ValueError(f"{checkpoint_path}: not a JAX package checkpoint (no state)")
        payload["state_format"] = FLAX_STATE
        return payload
    return torch.load(checkpoint_path, map_location="cpu", weights_only=True)


def model_weights(payload: Dict[str, Any], model, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The state dict to load into ``model`` from a checkpoint payload of
    either package: its parameters and running statistics, the parameters
    replaced by their EMA averages when ``use_ema`` and the checkpoint has
    them (a VQ model's codebook buffers always come from the run's own)."""
    state = payload["state"]
    if payload.get("state_format") == FLAX_STATE:
        from midi_vae_tpu_torch.interop.from_jax import torch_state_dict

        return torch_state_dict(model, state.get("params", {}), state.get("batch_stats", {}),
                                ema_params=state.get("ema_params") if use_ema else None)
    weights = dict(state["model"])
    if use_ema and state.get("ema_params"):
        weights.update(state["ema_params"])
    return weights


def has_ema(payload: Dict[str, Any]) -> bool:
    """Whether a checkpoint payload of either package carries EMA averages."""
    return bool(payload["state"].get("ema_params"))


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
    replace) or directory (``best_model.orbax``, staged and swapped); rank 0
    of a data-parallel run copies, the others only return the path."""
    if os.path.isdir(checkpoint_path):
        from midi_vae_tpu_torch.io.dcp_io import ORBAX_BEST_MODEL, copy_best_dir

        best_path = best_path or os.path.join(os.path.dirname(checkpoint_path), ORBAX_BEST_MODEL)
        return copy_best_dir(checkpoint_path, best_path) if is_leader() else best_path
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
