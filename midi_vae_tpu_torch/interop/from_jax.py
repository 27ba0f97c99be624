"""Weight bridge: flax variables → the PyTorch port's modules.

Takes the JAX package's ``params`` and ``batch_stats`` as nested dicts of
numpy arrays (``jax.device_get`` of the flax variables) and loads them
into a model of this package. The torch modules carry flax's module
names, so a torch name maps onto a flax path piece by piece; only the
leaf name and the layout change:

=============================  ==========================  ===========================
torch (module.leaf)            flax (collection/leaf)      layout
=============================  ==========================  ===========================
Conv.weight (also MaskedConv)  params/kernel               HWIO → OIHW
ConvTranspose.weight           params/kernel               flip H, W; HWIO → IOHW
TorchConvTranspose.weight      params/kernel               HWIO → IOHW (stored unflipped)
Dense.weight                   params/kernel               [in..., out...] → [out, in]
BatchNorm.weight (also         params/scale                as is
  SubsampledBatchNorm)
BatchNorm.running_mean         batch_stats/mean            as is
BatchNorm.running_var          batch_stats/var             as is
GroupNorm.weight               params/scale                as is
LayerNorm.weight               params/scale                as is
VectorQuantizerEMA.<buffer>    batch_stats/<buffer>        as is
TransformerCodePrior.bos,      params/bos, pos_embed       as is
  .pos_embed
*.bias                         params/bias                 flattened
=============================  ==========================  ===========================

A Dense's flax kernel may have more than two axes: the attention's
``query``/``key``/``value`` kernels are [F, H, F/H] and ``out`` [H, F/H,
F] (flax ``DenseGeneral``), flattened here to the torch [out, in] matrix.
A ``MaskedConv``'s mask is a constant outside the state dict. A
conditional model's ``fc_mu``/``fc_var``/``decoder_input`` kernels are
wider by the class count on both sides, and MLPVAE's list-named layers
(``encoder_0``, ``decoder_1``, …) carry flax's names, so both map by the
same rules.

:func:`flax_name_map` exposes the mapping, and :func:`to_flax_layout`
converts back, so tests can compare gradients and updated parameters
name by name.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from midi_vae_tpu_torch.models.prior import LayerNorm, TransformerCodePrior
from midi_vae_tpu_torch.models.vae import BatchNorm, Conv, ConvTranspose, Dense, GroupNorm, TorchConvTranspose
from midi_vae_tpu_torch.models.vq import VectorQuantizerEMA

_BN_LEAVES = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}
_LAYER_LEAVES = {"weight": ("params", "kernel"), "bias": ("params", "bias")}
_LN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias")}
_QUANTIZER_LEAVES = {k: ("batch_stats", k) for k in ("codebook", "cluster_size", "embed_avg")}
_PRIOR_LEAVES = {k: ("params", k) for k in ("bos", "pos_embed")}


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str, Tuple[str, ...]]:
    *mod_path, leaf = name.split(".")
    return model.get_submodule(".".join(mod_path)), leaf, tuple(mod_path)


def flax_name_map(model: nn.Module) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """torch ``state_dict`` name → (flax collection, flax path within it)."""
    out = {}
    for name in model.state_dict():
        module, leaf, mod_path = _owner(model, name)
        if isinstance(module, BatchNorm):
            collection, flax_leaf = _BN_LEAVES[leaf]
        elif isinstance(module, (Conv, ConvTranspose, TorchConvTranspose, Dense)):
            collection, flax_leaf = _LAYER_LEAVES[leaf]
        elif isinstance(module, (LayerNorm, GroupNorm)):
            collection, flax_leaf = _LN_LEAVES[leaf]
        elif isinstance(module, VectorQuantizerEMA):
            collection, flax_leaf = _QUANTIZER_LEAVES[leaf]
        elif isinstance(module, TransformerCodePrior) and leaf in _PRIOR_LEAVES:
            collection, flax_leaf = _PRIOR_LEAVES[leaf]
        else:
            raise TypeError(f"no flax counterpart known for {name} ({type(module).__name__})")
        out[name] = (collection, mod_path + (flax_leaf,))
    return out


def _to_torch(module: nn.Module, leaf: str, array: np.ndarray) -> np.ndarray:
    if isinstance(module, Dense):
        out, inp = module.weight.shape
        return array.reshape(inp, out).T if leaf == "weight" else array.reshape(-1)
    if leaf != "weight":
        return array
    if isinstance(module, Conv):
        return array.transpose(3, 2, 0, 1)
    if isinstance(module, ConvTranspose):
        return np.flip(array, (0, 1)).transpose(2, 3, 0, 1)
    if isinstance(module, TorchConvTranspose):
        return array.transpose(2, 3, 0, 1)
    return array


def to_flax_layout(model: nn.Module, name: str, tensor: torch.Tensor) -> np.ndarray:
    """A torch tensor of parameter/buffer ``name`` (or its gradient) in flax's layout."""
    module, leaf, _ = _owner(model, name)
    array = tensor.detach().cpu().float().numpy()
    if leaf != "weight":
        return array
    if isinstance(module, Conv):
        return array.transpose(2, 3, 1, 0)
    if isinstance(module, ConvTranspose):
        return np.flip(array, (2, 3)).transpose(2, 3, 0, 1)
    if isinstance(module, TorchConvTranspose):
        return array.transpose(2, 3, 0, 1)
    if isinstance(module, Dense):
        return array.T
    return array


def _lookup(tree: Mapping, path: Tuple[str, ...]) -> np.ndarray:
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@torch.no_grad()
def load_flax_variables(model: nn.Module, params: Mapping, batch_stats: Mapping) -> None:
    """Copy flax ``params`` and ``batch_stats`` into ``model`` in place.

    Raises if a torch entry has no flax counterpart or the shapes differ.
    """
    trees = {"params": params, "batch_stats": batch_stats}
    state = model.state_dict()
    for name, (collection, path) in flax_name_map(model).items():
        module, leaf, _ = _owner(model, name)
        value = _to_torch(module, leaf, _lookup(trees[collection], path))
        if tuple(value.shape) != tuple(state[name].shape):
            raise ValueError(f"{name}: flax {'/'.join(path)} has shape {value.shape}, torch {tuple(state[name].shape)}")
        state[name].copy_(torch.from_numpy(np.ascontiguousarray(value)))
