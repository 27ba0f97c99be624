"""ELBO loss: BCE reconstruction + weighted Gaussian KL (counterpart of
``midi_vae_tpu/losses/elbo.py``).

reconstruction = clamped BCE from logits, mean over every element;
KL = −0.5·mean_batch(sum_latent(1 + log_var − mu² − exp(log_var))), in f32;
total = reconstruction + kld_weight·KL; ``kld_loss`` is the negated KL.
Options: free bits (a per-dimension KL floor on the optimised term) and
BCE targets de-normalised back to [0, 1] (``--bce-targets raw``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from midi_vae_tpu_torch.core.types import LossOutput, ModelOutput
from midi_vae_tpu_torch.parallel.collectives import CrossRank, all_reduce_sum, group_size

_LOG_CLAMP = -100.0  # torch binary_cross_entropy clamps log terms at -100


def bce_from_logits(
    logits: torch.Tensor, targets: torch.Tensor, pos_weight: Optional[float] = None
) -> torch.Tensor:
    """Elementwise ``-[pw·t·max(log σ(l), −100) + (1−t)·max(log(1−σ(l)), −100)]`` in f32.

    The clamp keeps BCE bounded for the normalised targets in [−0.5, 0.5]
    that the reference trains on; ``pos_weight`` multiplies the
    positive-class term (torch ``BCEWithLogitsLoss`` convention).
    """
    logits = logits.float()
    targets = targets.float()
    log_p = (-F.softplus(-logits)).clamp_min(_LOG_CLAMP)
    log_1mp = (-F.softplus(logits)).clamp_min(_LOG_CLAMP)
    pw = 1.0 if pos_weight is None else pos_weight
    return -(pw * targets * log_p + (1.0 - targets) * log_1mp)


def kl_gaussian(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, σ²) || N(0, I)): sum over the latent dim, mean over the batch, in f32."""
    mu, log_var = mu.float(), log_var.float()
    return -0.5 * torch.mean(torch.sum(1.0 + log_var - mu**2 - torch.exp(log_var), dim=-1))


def kl_gaussian_free_bits(
    mu: torch.Tensor, log_var: torch.Tensor, free_bits: float, group: Optional[CrossRank] = None
) -> torch.Tensor:
    """Free-bits KL (Kingma et al. 2016): per-dimension batch-mean KL floored
    at ``free_bits`` nats, summed over dimensions, in f32. Dimensions under
    the floor add a constant and get no gradient. With ``group``, the batch
    is this rank's rows of one spread over the group's ranks in equal
    shards: the per-dimension means are taken over all of it (one
    differentiable all-reduce) before the floor."""
    mu, log_var = mu.float(), log_var.float()
    kl_dim = -0.5 * torch.mean(1.0 + log_var - mu**2 - torch.exp(log_var), dim=0)
    if group is not None:
        kl_dim = all_reduce_sum(kl_dim, group.group) / group_size(group.group)
    return torch.sum(torch.clamp_min(kl_dim, free_bits))


def denormalized_targets(targets: torch.Tensor, target_denorm) -> torch.Tensor:
    """Undo the input normalisation on the BCE targets: t·std + mean, clipped
    to [0, 1]. ``target_denorm`` is ``((mean, ...), (std, ...))``, one value
    per channel of the NHWC targets."""
    mean, std = target_denorm
    t = targets.float()
    if len(std) == 1:  # Python floats: no host-to-device copy per step
        return torch.clamp(t * float(std[0]) + float(mean[0]), 0.0, 1.0)
    std_c = torch.tensor(std, dtype=t.dtype, device=t.device).reshape(1, 1, 1, -1)
    mean_c = torch.tensor(mean, dtype=t.dtype, device=t.device).reshape(1, 1, 1, -1)
    return torch.clamp(t * std_c + mean_c, 0.0, 1.0)


def elbo_loss(
    output: ModelOutput,
    kld_weight: float = 1.0,
    log_var_clamp: Optional[Tuple[float, float]] = None,
    free_bits: Optional[float] = None,
    pos_weight: Optional[float] = None,
    target_denorm=None,
    free_bits_group: Optional[CrossRank] = None,
) -> LossOutput:
    """VAE loss on the unfused path (reference: ``VanillaVAE.loss``).

    ``kld_weight`` is a host float (the schedules' output).
    ``log_var_clamp`` clips log_var before the KL. ``free_bits`` floors
    the optimised KL term per dimension (:func:`kl_gaussian_free_bits`,
    over ``free_bits_group``'s global batch when given); the reported
    ``kl`` stays the true KL. ``target_denorm`` takes the
    BCE against the de-normalised targets (:func:`denormalized_targets`).
    """
    targets = output.input
    if target_denorm is not None:
        targets = denormalized_targets(targets, target_denorm)
    loss_recon = torch.mean(bce_from_logits(output.logits, targets, pos_weight))
    log_var = output.encoded.log_var
    if log_var_clamp is not None:
        log_var = log_var.clamp(log_var_clamp[0], log_var_clamp[1])
    kl = kl_gaussian(output.encoded.mu, log_var)
    kl_term = kl if free_bits is None else kl_gaussian_free_bits(
        output.encoded.mu, log_var, free_bits, free_bits_group
    )
    loss = loss_recon + kld_weight * kl_term
    return LossOutput(
        loss=loss,
        reconstruction_loss=loss_recon.detach(),
        kld_loss=-kl.detach(),
        kl=kl.detach(),
        # filled on the device: a host tensor copied over would wait for the queue
        kld_weight=torch.full((), float(kld_weight), dtype=loss.dtype, device=loss.device),
    )
