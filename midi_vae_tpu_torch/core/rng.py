"""Seeds of a run (counterpart of ``midi_vae_tpu/core/rng.py``).

Two kinds of randomness, both stable under a resume at any epoch:

- host shuffles: :func:`host_epoch_seed` and :func:`host_rng` are the JAX
  package's own numpy functions, so a loader walks the same permutation
  in both packages for a seed;
- device draws: :func:`epoch_seed` is an integer per (run seed, epoch),
  the counterpart of ``epoch_key``; each step's reparameterization seed is
  :func:`derive_step_seed` of (epoch seed, step), so a resumed run
  replays the draws of an uninterrupted one. The loaders key a batch's
  random transforms the same way from :func:`host_epoch_seed`. A rank of a
  data-parallel run draws its rows of the global draw (the models'
  ``rows=``), or under the explicit step its own :func:`derive_shard_seed`.

Discrete draws (:func:`categorical`) take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

# the clamp the JAX package applies before seeding (core/rng.py:28)
_SEED_MODULUS = 0xFFFF_FFFF


def epoch_seed(seed: int, epoch: int) -> int:
    """Integer seed of one epoch, in [0, 2**31): depends only on (seed,
    epoch), never on how many epochs this process ran."""
    if epoch == 0:
        raise ValueError("Epoch must be indexed from 1, not 0.")
    ss = np.random.SeedSequence([seed % _SEED_MODULUS, epoch, 0x5EED])
    return int(ss.generate_state(1, dtype=np.uint32)[0]) & 0x7FFFFFFF


def derive_step_seed(epoch_seed: int, step: int) -> int:
    """The seed of ``step`` within an epoch, in [0, 2**31): a SplitMix-style
    hash of (epoch seed, step) on the host — the counterpart of
    ``fold_in(epoch_key, step)``, with no device work."""
    key = (int(epoch_seed) * 0x9E3779B97F4A7C15 + int(step)) % 2**64
    key = ((key ^ (key >> 31)) * 0xBF58476D1CE4E5B9) % 2**64
    return (key ^ (key >> 32)) & 0x7FFFFFFF


def derive_micro_seed(step_seed: int, micro: int) -> int:
    """The seed of micro-batch ``micro`` of an accumulated step, in [0,
    2**31): the counterpart of ``fold_in(step_key, micro)``, hashed as
    :func:`derive_step_seed` hashes a step into its epoch."""
    return derive_step_seed(step_seed, micro)


def derive_shard_seed(step_seed: int, coords) -> int:
    """The seed of one shard of an explicit data-parallel step, in [0,
    2**31): ``step_seed`` with each of the rank's mesh coordinates folded
    in, axis by axis (slice index, then data index), as the JAX package's
    ``shard_map`` step folds ``axis_index`` of each mesh axis into its key.
    The shard at the origin keeps ``step_seed``, so over one device the
    explicit step draws what the one-device step draws."""
    coords = [int(c) for c in coords]
    if not any(coords):
        return int(step_seed)
    seed = int(step_seed)
    for c in coords:
        seed = derive_step_seed(seed, c)
    return seed


def host_epoch_seed(seed: int, epoch: int, process_index: int = 0) -> int:
    """Deterministic integer seed for host-side numpy shuffling: stable under
    resume, distinct across epochs and processes (as the JAX package's)."""
    if epoch == 0:
        raise ValueError("Epoch must be indexed from 1, not 0.")
    ss = np.random.SeedSequence([seed % _SEED_MODULUS, epoch, process_index])
    return int(ss.generate_state(1, dtype=np.uint32)[0])


def host_rng(seed: int, epoch: int, process_index: int = 0) -> np.random.Generator:
    """Numpy Generator seeded with :func:`host_epoch_seed`."""
    return np.random.default_rng(host_epoch_seed(seed, epoch, process_index))


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row of ``[..., K]`` logits (−inf entries are never
    drawn), as ``jax.random.categorical`` draws: the argmax of the logits
    plus Gumbel noise, here from ``generator`` on the logits' device. The
    stream advances by one uniform per logit whatever the values, so draws
    at later calls do not depend on earlier logits."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)
