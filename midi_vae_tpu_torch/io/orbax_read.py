"""Read a checkpoint directory the JAX package's Orbax backend wrote
(``--checkpoint-backend orbax``; counterpart of ``midi_vae_tpu/io/orbax_io.py``
``load_checkpoint_orbax`` without a template), with no JAX, Orbax or
tensorstore.

Such a directory holds ``midi_vae_meta.json`` (the payload's config and
counters) and ``state/``: Orbax's ``_METADATA``, whose ``tree_metadata``
names every leaf by its key path, and an OCDBT key-value store
(``io/ocdbt.py``) holding one zarr v2 array per leaf (``io/zarr2.py``),
named by the key path joined with ``.``. The nesting is taken from the
key paths, since a flax module's name may itself hold a dot.

:func:`load_jax_orbax` returns the payload ``io/checkpoint.py`` returns for
a JAX ``.msgpack`` checkpoint: ``"state"`` is the flax state (``params``,
``batch_stats``, ``opt_state``, ``step``, ``ema_params``) with numpy
leaves (``torch.bfloat16`` tensors for bf16 arrays), marked
``"state_format": "flax"``. As in the JAX package, a directory missing at
``path`` is read from ``path.old`` (the swap a crash interrupted), and a
``path.staging`` an asynchronous write left behind is ignored.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

from midi_vae_tpu_torch.io.ocdbt import OcdbtStore
from midi_vae_tpu_torch.io.zarr2 import read_array

_META_NAME = "midi_vae_meta.json"
_DICT_KEY = 2  # the JAX package saves flax state dicts: lists are dicts keyed "0", "1", ...
# leaves Orbax records without data, and what they restore as
_EMPTY = {"Dict": dict, "None": lambda: None}


def _insert(tree: dict, keys, leaf) -> None:
    node = tree
    for key in keys[:-1]:
        node = node.setdefault(key, {})
    node[keys[-1]] = leaf


def read_state(state_dir: str) -> Dict[str, Any]:
    """The state tree of an Orbax ``state/`` directory."""
    with open(os.path.join(state_dir, "_METADATA")) as f:
        metadata = json.load(f)
    if not metadata.get("use_ocdbt", False):
        raise ValueError(f"{state_dir}: not an OCDBT checkpoint (use_ocdbt false); only OCDBT is read")
    if metadata.get("use_zarr3", False):
        raise ValueError(f"{state_dir}: zarr v3 arrays; only zarr v2 is read")
    store = OcdbtStore(state_dir)
    tree: Dict[str, Any] = {}
    for path_repr, entry in metadata["tree_metadata"].items():
        if any(k["key_type"] != _DICT_KEY for k in entry["key_metadata"]):
            raise ValueError(f"{state_dir}: leaf {path_repr} sits under a key that is not a dict key")
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        kind = value["value_type"]
        if value.get("skip_deserialize"):
            if kind not in _EMPTY:
                raise ValueError(f"{state_dir}: leaf {path_repr} of type {kind!r} holds no data")
            leaf = _EMPTY[kind]()
        else:
            leaf = read_array(store, ".".join(keys))
            if kind == "scalar":
                leaf = leaf.item()
            elif kind not in ("np.ndarray", "jax.Array"):
                raise ValueError(f"{state_dir}: leaf {path_repr} of unknown type {kind!r}")
        _insert(tree, keys, leaf)
    return tree


def load_jax_orbax(checkpoint_path: str) -> Dict[str, Any]:
    """The payload of a JAX package Orbax checkpoint directory (or of its
    ``.old`` fallback)."""
    from midi_vae_tpu_torch.io.checkpoint import FLAX_STATE
    from midi_vae_tpu_torch.io.dcp_io import _resolve

    resolved = _resolve(checkpoint_path)
    if resolved is None:
        raise FileNotFoundError(f"no Orbax checkpoint at '{checkpoint_path}' (or its .old fallback)")
    if resolved != os.path.abspath(checkpoint_path):
        print(f"Recovering checkpoint from swap-window fallback '{resolved}'")
    with open(os.path.join(resolved, _META_NAME)) as f:
        payload: Dict[str, Any] = json.load(f)
    payload["state"] = read_state(os.path.join(resolved, "state"))
    payload["state_format"] = FLAX_STATE
    return payload
