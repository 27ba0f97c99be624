"""Importance-weighted log-likelihood bound (IWAE, Burda et al. 2016;
counterpart of ``midi_vae_tpu/evaluation/iwae.py``).

    log p(x) >= E[ log (1/K) sum_k  p(x|z_k) p(z_k) / q(z_k|x) ],  z_k ~ q(z|x)

The bound tightens towards log p(x) as K grows; K = 1 is a one-sample
ELBO estimate. Pass ``target_denorm`` (the transform's ``(mean, std)``)
to score the de-normalised [0, 1] pixels: a Bernoulli likelihood needs
targets in [0, 1]. The per-element log-likelihood is the training
objective's −100-clamped BCE (plain PyTorch: no kernel runs here).

The K decodes are chunked, ``chunk`` draws per call with ``logaddexp``
across chunks, so device memory is bounded by ``chunk × batch`` images
whatever K. Draw j of batch i is keyed by (seed, i, j) alone
(:func:`iwae_draws`), as ``fold_in(batch_key, offset + j)`` keys it in
the JAX package, so any chunking reduces the same draws. A conditional
model encodes under the batch labels and decodes each draw under its
sample's label (the bound is on p(x|y)).

On a rank of a data-parallel run (``mesh``, and a loader of its rows) a
batch's draws are the global batch's at this rank's rows, and the sums
are reduced over the data group: every rank returns the one-rank bound.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from midi_vae_tpu_torch.core.rng import derive_step_seed
from midi_vae_tpu_torch.evaluation.inference import normal_draw
from midi_vae_tpu_torch.losses.elbo import bce_from_logits, denormalized_targets
from midi_vae_tpu_torch.models.vae import label_kwarg
from midi_vae_tpu_torch.parallel.collectives import all_reduce_

_LOG_2PI = math.log(2.0 * math.pi)


def iwae_draws(batch_seed: int, offset: int, chunk: int, b: int, d: int, device) -> torch.Tensor:
    """eps [chunk, b, d] for draws ``offset .. offset + chunk − 1`` of one
    batch: draw j is the f32 normal draw keyed by
    ``derive_step_seed(batch_seed, j)`` (on the CPU, then copied)."""
    return torch.stack(
        [normal_draw((b, d), derive_step_seed(batch_seed, offset + j), "cpu") for j in range(chunk)]
    ).to(device)


def make_iwae_step(model, chunk: int, target_denorm: Optional[Tuple] = None) -> Callable:
    """Build ``iwae_step(x, batch_seed, offset, *, y=None, eps=None) → [B]``:
    the per-sample log-sum-exp of ``chunk`` importance weights, unnormalised
    (the sweep divides by the total K once, so chunks compose exactly).
    ``y`` reaches conditional models only; ``eps`` [chunk, B, D] replaces
    the draws; ``rows`` = (positions, global batch) takes those positions
    of the global batch's draws."""

    @torch.inference_mode()
    def iwae_step(x: torch.Tensor, batch_seed: int, offset: int, *, y=None, eps: Optional[torch.Tensor] = None,
                  rows=None):
        enc = model.encode(x, train=False, **label_kwarg(model, y))
        mu = enc.mu.float()
        log_var = enc.log_var.float()
        b, d = mu.shape
        if eps is None and rows is None:
            eps = iwae_draws(batch_seed, offset, chunk, b, d, mu.device)
        elif eps is None:  # this rank's rows of the global batch's draws
            positions, total = rows
            eps = iwae_draws(batch_seed, offset, chunk, total, d, mu.device)[:, positions.to(mu.device)]
        eps = eps.to(mu.device, torch.float32)
        z = mu[None] + eps * torch.exp(0.5 * log_var)[None]

        logits = model.decode_logits(z.reshape(chunk * b, d), train=False,
                                     **label_kwarg(model, None if y is None else y.repeat(chunk)))
        logits = logits.reshape(chunk, b, *logits.shape[1:]).float()
        targets = x if target_denorm is None else denormalized_targets(x, target_denorm)
        # Bernoulli log p(x|z_k): [chunk, B], the clamped log-likelihood summed over pixels
        ll = -torch.sum(bce_from_logits(logits, targets[None]), dim=tuple(range(2, logits.ndim)))
        # log p(z) − log q(z|x): the N(0, 1) prior and N(mu, σ²) at z, where (z − mu)/σ = eps
        log_p = -0.5 * torch.sum(torch.square(z) + _LOG_2PI, dim=-1)
        log_q = -0.5 * torch.sum(torch.square(eps) + _LOG_2PI + log_var[None], dim=-1)
        return torch.logsumexp(ll + log_p - log_q, dim=0)

    return iwae_step


def iwae_bound(
    loader,
    model,
    *,
    k: int = 64,
    chunk: int = 16,
    seed: int = 0,
    target_denorm: Optional[Tuple] = None,
    mesh=None,
) -> float:
    """Dataset-mean IWAE bound in nats per sample (higher is better) over
    ``loader.epoch(1)``; padding rows (mask 0) are dropped on the device,
    and each batch's masked sum is read to the host once. ``mesh``: this
    rank's mesh, for a loader of its rows."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if getattr(model, "latent_kind", "gaussian") == "vq":
        raise ValueError(
            "the IWAE bound assumes a Gaussian posterior q(z|x); a VQ-VAE's "
            "posterior is a point mass on the nearest code — use the "
            "reconstruction metrics / codebook perplexity instead"
        )
    chunk = min(chunk, k)
    n_chunks, rem = divmod(k, chunk)
    sizes = [chunk] * n_chunks + ([rem] if rem else [])
    steps = {size: make_iwae_step(model, size, target_denorm) for size in set(sizes)}

    rows = getattr(loader, "rows", None)
    if rows is not None:
        rows = (torch.from_numpy(rows), loader.batch_size)
    total = 0.0
    count = 0
    for i, batch in enumerate(loader.epoch(1)):
        batch_seed = derive_step_seed(seed, i)
        lse = None
        offset = 0
        for size in sizes:
            part = steps[size](batch.x, batch_seed, offset, y=batch.y, rows=rows)
            offset += size
            lse = part if lse is None else torch.logaddexp(lse, part)
        mask = batch.mask > 0
        total += float(torch.where(mask, lse - math.log(k), 0.0).sum())
        count += int(mask.sum())
    if mesh is not None:
        sums = torch.tensor([total, count], dtype=torch.float64, device=batch.x.device)
        all_reduce_([sums], mesh.data_group)
        total, count = float(sums[0]), int(sums[1])
    if count == 0:
        raise ValueError("empty evaluation stream")
    return total / count
