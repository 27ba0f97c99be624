"""Model registry (counterpart of ``midi_vae_tpu/models/registry.py``).

Every architecture of the JAX registry: ``VanillaVAE``, ``FoldedVAE``,
``MLPVAE`` and the VQ-VAEs ``VQVAE`` and ``FoldedVQVAE``, with every
variant the JAX registry builds (stem, head, norm, torch_compat, remat,
verbose); the combinations it refuses raise its ``ValueError`` messages.
The Gaussian models take ``num_classes`` > 0 to become conditional.
:func:`register_model` adds an architecture under a name of its own, which
:func:`build_model` and the CLIs' ``--model`` then reach.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from midi_vae_tpu_torch.core.device import DeviceLike, resolve_device
from midi_vae_tpu_torch.models.folded import FoldedVAE
from midi_vae_tpu_torch.models.mlp import MLPVAE
from midi_vae_tpu_torch.models.vae import VanillaVAE
from midi_vae_tpu_torch.models.vq import VQVAE, FoldedVQVAE

MODEL_REGISTRY = {
    "vanillavae": VanillaVAE, "mlpvae": MLPVAE, "foldedvae": FoldedVAE, "vqvae": VQVAE, "foldedvqvae": FoldedVQVAE,
}
VQ_ARCHS = ("vqvae", "foldedvqvae")
# the built-in classes, most derived first: a registered class takes the keywords of the first it derives from
_FAMILIES = (("foldedvqvae", FoldedVQVAE), ("vqvae", VQVAE), ("foldedvae", FoldedVAE), ("mlpvae", MLPVAE))


def register_model(name: str, ctor: Callable[..., torch.nn.Module]) -> None:
    """Add ``ctor`` to the registry under ``name`` (case-insensitive), as the
    JAX package's ``register_model`` does. :func:`build_model` calls it with
    the keywords, and applies the refusals, of the built-in architecture it
    derives from (the nearest of FoldedVQVAE, VQVAE, FoldedVAE, MLPVAE;
    VanillaVAE's for any other class or callable)."""
    MODEL_REGISTRY[name.lower()] = ctor


def _family(ctor) -> str:
    """The built-in architecture whose keyword set ``ctor`` takes."""
    for key, cls in _FAMILIES:
        if isinstance(ctor, type) and issubclass(ctor, cls):
            return key
    return "vanillavae"


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
    codebook_size: int = 512,
    vq_decay: float = 0.99,
    torch_compat: bool = False,
    remat: bool = False,
    verbose: bool = False,
    seed: int = 0,
    device: DeviceLike = "cuda",
):
    """Construct a model by architecture name (case-insensitive), with
    Xavier-initialised parameters (and a VQ codebook) drawn from ``seed`` on
    the CPU and then moved to ``device`` (CUDA by default; raises when there
    is none). ``codebook_size`` and ``vq_decay`` apply to the VQ models,
    which refuse ``fused_reparam``, labels and ``torch_compat`` as the JAX
    package's registry does."""
    key = arch.lower()
    if key not in MODEL_REGISTRY:
        raise ValueError(f"Unrecognised architecture: {arch}. Ported: {sorted(MODEL_REGISTRY)}")
    ctor = MODEL_REGISTRY[key]
    family = _family(ctor)
    if family in VQ_ARCHS:
        if torch_compat:
            raise ValueError("torch_compat is reference-parity mode; the reference has no VQ-VAE")
        if fused_reparam:
            raise ValueError("VQVAE has no reparameterization; drop --fused")
        if num_classes:
            raise ValueError("VQVAE has no conditional variant; use --model VanillaVAE for --conditional")
    if torch_compat and family == "mlpvae":
        raise ValueError("torch_compat is the reference-parity mode of VanillaVAE; MLPVAE has no reference twin")
    if num_classes < 0:
        raise ValueError(
            "conditional training needs a labeled dataset with a known class "
            f"count; got num_classes={num_classes} (unlabeled/by-folder)"
        )
    dev = resolve_device(device)
    kwargs = dict(
        in_channels=in_channels,
        latent_dim=latent_dim,
        input_dim=input_dim,
        fused_reparam=fused_reparam,
        output_logit_bias=output_logit_bias,
        num_classes=int(num_classes),
        remat=remat,
        verbose=verbose,
        generator=torch.Generator().manual_seed(seed),
    )
    if family == "mlpvae":
        if norm != "batch":
            raise ValueError("--norm applies to conv architectures; MLPVAE has no norm layers")
        if stem != "conv" or head != "deconv":
            raise ValueError("--stem/--head apply to conv architectures; MLPVAE has neither")
    else:
        kwargs.update(stem=stem, head=head, norm=norm)
    if torch_compat:
        kwargs["torch_compat"] = True
    if hidden_dims is not None:
        kwargs["hidden_dims"] = tuple(hidden_dims)
    if dtype is not None:
        kwargs["dtype"] = dtype
    if family in ("foldedvae", "foldedvqvae"):
        kwargs["fold"] = fold
    if family in VQ_ARCHS:
        kwargs.update(codebook_size=int(codebook_size), vq_decay=float(vq_decay))
    return ctor(**kwargs).to(dev)
