"""Model registry (counterpart of ``midi_vae_tpu/models/registry.py``).

Ported so far: ``VanillaVAE`` (reference layout) and ``FoldedVAE``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from midi_vae_tpu_torch.core.device import DeviceLike, resolve_device
from midi_vae_tpu_torch.models.folded import FoldedVAE
from midi_vae_tpu_torch.models.vae import VanillaVAE

MODEL_REGISTRY = {"vanillavae": VanillaVAE, "foldedvae": FoldedVAE}


def build_model(
    arch: str,
    *,
    in_channels: int,
    latent_dim: int,
    input_dim: int,
    hidden_dims: Optional[Sequence[int]] = None,
    dtype: Optional[torch.dtype] = None,
    fused_reparam: bool = False,
    fold: int = 4,
    output_logit_bias: Optional[float] = None,
    stem: str = "conv",
    head: str = "deconv",
    norm: str = "batch",
    num_classes: int = 0,
    seed: int = 0,
    device: DeviceLike = "cuda",
):
    """Construct a model by architecture name (case-insensitive), with
    Xavier-initialised parameters drawn from ``seed`` on the CPU and then
    moved to ``device`` (CUDA by default; raises when there is none)."""
    key = arch.lower()
    if key not in MODEL_REGISTRY:
        raise ValueError(f"Unrecognised architecture: {arch}. Ported: {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    kwargs = dict(
        in_channels=in_channels,
        latent_dim=latent_dim,
        input_dim=input_dim,
        fused_reparam=fused_reparam,
        output_logit_bias=output_logit_bias,
        stem=stem,
        head=head,
        norm=norm,
        num_classes=num_classes,
        generator=torch.Generator().manual_seed(seed),
    )
    if hidden_dims is not None:
        kwargs["hidden_dims"] = tuple(hidden_dims)
    if dtype is not None:
        kwargs["dtype"] = dtype
    if key == "foldedvae":
        kwargs["fold"] = fold
    return MODEL_REGISTRY[key](**kwargs).to(dev)
