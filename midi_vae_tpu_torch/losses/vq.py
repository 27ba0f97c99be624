"""VQ-VAE objective: reconstruction + commitment (counterpart of
``midi_vae_tpu/losses/vq.py``).

    L = mean BCE(x̂, x) + β · mean((z_e − sg[z_q])²)

The BCE is the Gaussian ELBO's (``losses/elbo.py``: the −100 clamp,
``pos_weight``, de-normalised raw targets); the codebook learns by the
quantizer's EMA updates, not by this loss. ``LossOutput`` mapping:
``kl`` is the commitment term, ``kld_loss`` its negation, ``kld_weight``
the commitment weight β (the KL-weight schedules drive it).
"""

from __future__ import annotations

from typing import Optional

import torch

from midi_vae_tpu_torch.core.types import LossOutput, ModelOutput
from midi_vae_tpu_torch.losses.elbo import bce_from_logits, denormalized_targets


def vq_loss(
    output: ModelOutput,
    commitment_weight: float = 0.25,
    pos_weight: Optional[float] = None,
    target_denorm=None,
) -> LossOutput:
    """VQ objective from a VQ model's ``ModelOutput``: ``encoded.mu`` is the
    flattened z_e and ``latents`` the straight-through value, whose forward
    value is z_q, so its detached copy is sg[z_q]."""
    targets = output.input
    if target_denorm is not None:
        targets = denormalized_targets(targets, target_denorm)
    loss_recon = torch.mean(bce_from_logits(output.logits, targets, pos_weight))
    commit = torch.mean(torch.square(output.encoded.mu.float() - output.latents.float().detach()))
    loss = loss_recon + float(commitment_weight) * commit
    return LossOutput(
        loss=loss,
        reconstruction_loss=loss_recon.detach(),
        kld_loss=-commit.detach(),
        kl=commit.detach(),
        kld_weight=torch.full((), float(commitment_weight), dtype=loss.dtype, device=loss.device),
    )
