"""The reference's torch ``state_dict`` ↔ the port's ``torch_compat`` VanillaVAE
(counterpart of ``midi_vae_tpu/interop/torch_import.py`` and
``torch_export.py``).

The reference (finlaymiller/torch-vae ``VanillaVAE``) serializes as::

    encoder.{i}.0.{weight,bias}                              Conv2d
    encoder.{i}.1.{weight,bias,running_mean,running_var,     BatchNorm2d
                   num_batches_tracked}
    fc_mu.*  fc_var.*  decoder_input.*                       Linear
    decoder.{i}.0.*  decoder.{i}.1.*                         ConvTranspose2d, BatchNorm2d
    final_layer.0.*  final_layer.1.*  final_layer.3.*        ConvTranspose2d, BatchNorm2d, Conv2d

The port's torch_compat model keeps torch's own layouts (``Conv.weight``
OIHW, ``TorchConvTranspose.weight`` IOHW), so every tensor maps key for key
and unchanged, with one exception: the port flattens the feature map in
(H, W, C) order where torch flattens (C, H, W), so the dense columns of
``fc_mu``/``fc_var`` and the rows (and bias) of ``decoder_input`` are
permuted (:func:`flatten_permutation`). The JAX package's HWIO layout
conversions have no counterpart here: torch reads torch.

Import and export are exact inverses: a reference ``state_dict`` comes
back bitwise, ``num_batches_tracked`` included when the export is given
the same count (the port's BatchNorm keeps none; JAX stamps the
checkpoint's step count).

CLI, a trained ``--torch-compat`` checkpoint's EMA weights (its raw
weights when it has none) to a reference ``state_dict``, written with
``torch.save``, or with ``np.savez`` when the path ends in ``.npz`` (the
JAX package's ``torch_export`` file, key for key)::

    python -m midi_vae_tpu_torch.interop.torch_reference --checkpoint CKPT --out ref.pt|ref.npz
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# reference BatchNorm2d leaf → the port's BatchNorm leaf
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def flatten_permutation(spatial: int, channels: int) -> np.ndarray:
    """``perm`` with ``port_flat[f] = torch_flat[perm[f]]`` for a
    (C, H, W)-row-major ↔ (H, W, C)-row-major flatten change (a copy of the
    JAX package's ``torch_import.flatten_permutation``)."""
    torch_indices = np.arange(spatial * spatial * channels).reshape(channels, spatial, spatial)
    return torch_indices.transpose(1, 2, 0).reshape(-1)


def _check_model(model) -> None:
    if type(model).__name__ != "VanillaVAE" or not getattr(model, "torch_compat", False):
        raise ValueError(
            "only VanillaVAE(torch_compat=True) has a reference twin "
            f"(got {type(model).__name__}, torch_compat={getattr(model, 'torch_compat', False)}); "
            "train with --torch-compat for a torch-exportable run"
        )
    if getattr(model, "num_classes", 0) > 0:
        raise ValueError(
            "conditional (--conditional) models widen the latent-head/decoder-input "
            "layers with the label one-hot; the torch reference has no conditional twin"
        )


def _key_pairs(model) -> List[Tuple[str, str]]:
    """(reference key, port key) for every tensor the two share."""
    pairs = []

    def bn(ref: str, port: str) -> None:
        pairs.extend((f"{ref}.{leaf}", f"{port}.{leaf}") for leaf in _BN_LEAVES)

    def layer(ref: str, port: str) -> None:
        pairs.extend((f"{ref}.{leaf}", f"{port}.{leaf}") for leaf in ("weight", "bias"))

    for i in range(len(model.hidden_dims)):
        layer(f"encoder.{i}.0", f"encoder.ConvBlock_{i}.Conv_0")
        bn(f"encoder.{i}.1", f"encoder.ConvBlock_{i}.BatchNorm_0")
    for head in ("fc_mu", "fc_var", "decoder_input"):
        layer(head, head)
    for i in range(len(model.hidden_dims) - 1):
        layer(f"decoder.{i}.0", f"decoder.DeconvBlock_{i}.ConvTranspose_0")
        bn(f"decoder.{i}.1", f"decoder.DeconvBlock_{i}.BatchNorm_0")
    layer("final_layer.0", "final_layer.DeconvBlock_0.ConvTranspose_0")
    bn("final_layer.1", "final_layer.DeconvBlock_0.BatchNorm_0")
    layer("final_layer.3", "final_layer.Conv_0")
    return pairs


def _permute(port_key: str, t: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorder the flattened-feature axis of ``t`` by ``perm`` (the dense
    layers touching the feature map; every other tensor passes through)."""
    if port_key in ("fc_mu.weight", "fc_var.weight"):
        return t[:, perm]
    if port_key in ("decoder_input.weight", "decoder_input.bias"):
        return t[perm]
    return t


def _perms(model) -> Tuple[torch.Tensor, torch.Tensor]:
    perm = flatten_permutation(model.last_conv_size, model.hidden_dims[-1])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return torch.from_numpy(perm), torch.from_numpy(inv)


@torch.no_grad()
def import_reference_state_dict(model, state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a reference ``state_dict`` (torch tensors or numpy arrays) into the
    port's ``VanillaVAE(torch_compat=True)`` in place. The reference's
    ``num_batches_tracked`` counters are not kept (the port counts none).
    Raises on a missing key or a shape that differs."""
    _check_model(model)
    perm, _ = _perms(model)
    state = model.state_dict()
    for ref_key, port_key in _key_pairs(model):
        if ref_key not in state_dict:
            raise KeyError(f"reference state_dict has no {ref_key!r}")
        value = _permute(port_key, torch.as_tensor(state_dict[ref_key]), perm)
        if tuple(value.shape) != tuple(state[port_key].shape):
            raise ValueError(f"{ref_key}: reference shape {tuple(value.shape)}, port {port_key} "
                             f"{tuple(state[port_key].shape)}")
        state[port_key].copy_(value)


@torch.no_grad()
def export_reference_state_dict(model, num_batches_tracked: int = 0) -> Dict[str, torch.Tensor]:
    """The port's ``VanillaVAE(torch_compat=True)`` → a reference-layout
    ``state_dict`` of CPU tensors, ready for the reference's
    ``load_state_dict``. Every BatchNorm's ``num_batches_tracked`` is
    stamped with ``num_batches_tracked`` (pass the run's step count)."""
    _check_model(model)
    _, inv = _perms(model)
    state = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for ref_key, port_key in _key_pairs(model):
        out[ref_key] = _permute(port_key, state[port_key].detach().cpu(), inv).clone()
        if ref_key.endswith(".running_var"):
            out[ref_key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(
                int(num_batches_tracked), dtype=torch.long)
    return out


def main(argv: Optional[list] = None) -> None:
    """Export a trained ``--torch-compat`` checkpoint to a reference
    ``state_dict``: ``np.savez`` for an ``.npz`` path, ``torch.save`` otherwise."""
    parser = argparse.ArgumentParser(description="Export a checkpoint to a torch-reference state_dict")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", required=True, help=".pt (torch.save) or .npz output path")
    args = parser.parse_args(argv)

    from midi_vae_tpu_torch.cli.generate import _load_model_and_state
    from midi_vae_tpu_torch.io.checkpoint import load_checkpoint

    payload = load_checkpoint(args.checkpoint)
    model, *_ = _load_model_and_state(args.checkpoint, use_ema=True, payload=payload, device="cpu")
    try:
        sd = export_reference_state_dict(model, num_batches_tracked=int(payload.get("total_step", 0)))
    except ValueError as e:
        raise SystemExit(str(e)) from e
    if args.out.endswith(".npz"):
        np.savez(args.out, **{k: v.numpy() for k, v in sd.items()})
    else:
        torch.save(sd, args.out)
    print(f"wrote {len(sd)} tensors to {args.out}")


if __name__ == "__main__":
    main()
