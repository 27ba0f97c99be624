"""Data contracts crossing layer boundaries (counterpart of
``midi_vae_tpu/core/types.py``), as plain dataclasses holding tensors.

Field names and meanings are the JAX package's, so code reading a
``ModelOutput`` or ``LossOutput`` reads the same attributes on both sides.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class EncoderOutput:
    """Output of a VAE encoder.

    mu : [B, D] posterior means
    log_var : [B, D] posterior log-variances
    pre_latents : [B, F] flattened feature map feeding the latent heads (NHWC order)
    """

    mu: torch.Tensor
    log_var: torch.Tensor
    pre_latents: torch.Tensor


@dataclass
class ModelOutput:
    """Output of a full VAE forward pass. Images are NHWC."""

    output: torch.Tensor  # reconstruction probabilities in [0, 1]
    logits: torch.Tensor  # pre-sigmoid reconstruction
    input: torch.Tensor  # the stimuli this reconstruction answers
    encoded: EncoderOutput
    latents: torch.Tensor  # reparameterized z ~ q(z|x)


@dataclass
class LossOutput:
    """Output of the ELBO loss. ``kld_loss`` is the negated KL (the
    reference's reporting convention); ``kl`` is the positive KL. All
    fields are 0-d tensors on the model's device."""

    loss: torch.Tensor
    reconstruction_loss: torch.Tensor
    kld_loss: torch.Tensor  # == -kl
    kl: torch.Tensor
    kld_weight: torch.Tensor
