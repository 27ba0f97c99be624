"""β-TC-VAE objective (Chen et al. 2018; counterpart of
``midi_vae_tpu/losses/tcvae.py``).

The KL term splits into index-code mutual information, total correlation
and dimension-wise KL, E_x[KL(q(z|x) ‖ p(z))] = MI + TC + DWKL, each
estimated by minibatch-weighted sampling over one [B, B, D] log-density
tensor of the batch's own samples. The loss is reconstruction + α·MI +
β·TC + γ·DWKL with α = γ = 1; the scheduled ``kld_weight`` scales the
whole KL block.

Everything after the forward runs in f32, whatever the model's compute
dtype. The estimator spans the batch it is given: under gradient
accumulation that is the micro-batch, as in the JAX package. On a rank of
a data-parallel step, ``gather`` gathers ``(z, mu, log_var)`` over
the group's ranks first, so the [B, B, D] density matrix spans the global
batch; every rank then computes the same KL block, the reconstruction
stays local, and the gather's backward (the sum over ranks, then this
rank's rows) hands each rank the gradient of its own latents.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from midi_vae_tpu_torch.core.types import LossOutput, ModelOutput
from midi_vae_tpu_torch.losses.elbo import bce_from_logits, denormalized_targets
from midi_vae_tpu_torch.parallel.collectives import CrossRank, concat_all_gather

_LOG_2PI = math.log(2.0 * math.pi)


def _gaussian_log_density(z: torch.Tensor, mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """Elementwise log N(z; mu, exp(log_var)); broadcasts."""
    return -0.5 * (_LOG_2PI + log_var + torch.square(z - mu) / torch.exp(log_var))


def tc_decomposition(
    z: torch.Tensor, mu: torch.Tensor, log_var: torch.Tensor, dataset_size: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mi, tc, dwkl): batch means of the three KL components for [B, D]
    samples ``z`` of the posteriors N(mu, exp(log_var)). ``dataset_size``
    is N in the normaliser log(B·N)."""
    b = z.shape[0]
    z, mu, log_var = (t.float() for t in (z, mu, log_var))
    # [B, B, D]: log q(z_i[d] | x_j) for every pair (i, j)
    mat = _gaussian_log_density(z[:, None, :], mu[None, :, :], log_var[None, :, :])
    log_norm = float(np.log(np.float32(b * dataset_size)))

    log_qz_cond = torch.sum(_gaussian_log_density(z, mu, log_var), dim=-1)  # log q(z_i|x_i)
    log_qz = torch.logsumexp(torch.sum(mat, dim=-1), dim=1) - log_norm  # log q(z_i)
    log_prod_qzd = torch.sum(torch.logsumexp(mat, dim=1) - log_norm, dim=-1)  # Σ_d log q(z_i[d])
    log_pz = torch.sum(-0.5 * (_LOG_2PI + torch.square(z)), dim=-1)

    mi = torch.mean(log_qz_cond - log_qz)
    tc = torch.mean(log_qz - log_prod_qzd)
    dwkl = torch.mean(log_prod_qzd - log_pz)
    return mi, tc, dwkl


def beta_tc_elbo_loss(
    output: ModelOutput,
    *,
    tc_beta: float = 6.0,
    dataset_size: int = 1,
    kld_weight: float = 1.0,
    log_var_clamp: Optional[Tuple[float, float]] = None,
    pos_weight: Optional[float] = None,
    target_denorm=None,
    gather: Optional[CrossRank] = None,
) -> LossOutput:
    """BCE reconstruction + ``kld_weight``·(MI + β·TC + DWKL), α = γ = 1.

    The reported ``kl`` is MI + TC + DWKL and ``kld_loss`` its negation, as
    the ELBO reports them. ``log_var_clamp`` clips log_var first;
    ``pos_weight`` and ``target_denorm`` act on the BCE as in
    :func:`~midi_vae_tpu_torch.losses.elbo.elbo_loss`. ``gather`` (a
    :class:`~midi_vae_tpu_torch.parallel.collectives.CrossRank`) gathers
    the latents over its group's ranks before the decomposition (JAX
    ``gather_axes``).
    """
    lv = output.encoded.log_var
    if log_var_clamp is not None:
        lv = lv.clamp(log_var_clamp[0], log_var_clamp[1])
    targets = output.input
    if target_denorm is not None:
        targets = denormalized_targets(targets, target_denorm)
    recon = torch.mean(bce_from_logits(output.logits, targets, pos_weight))
    z, mu = output.latents, output.encoded.mu
    if gather is not None:
        z, mu, lv = (concat_all_gather(t, gather.group) for t in (z, mu, lv))
    mi, tc, dwkl = tc_decomposition(z, mu, lv, dataset_size)
    loss = recon + float(kld_weight) * (mi + tc_beta * tc + dwkl)
    kl_total = (mi + tc + dwkl).detach()
    return LossOutput(
        loss=loss,
        reconstruction_loss=recon.detach(),
        kld_loss=-kl_total,
        kl=kl_total,
        kld_weight=torch.full((), float(kld_weight), dtype=loss.dtype, device=loss.device),
    )
