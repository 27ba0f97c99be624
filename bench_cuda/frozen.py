"""Frozen copies of what the port derives from a seed.

The benchmark makes its inputs itself, and its plain reference works out
again what the port derived from the seed, without importing the port.
These are copies of the port's rules as they stand, each held against the
port by a CPU test (``tests/test_bench_cuda_frozen.py``):

- :func:`make_rolls`: the synthetic piano-roll generator
  (``midi_vae_tpu_torch/data/synthetic.py`` ``make_pianoroll_batch``);
- :func:`epoch_seed`, :func:`step_seed`, :func:`host_epoch_seed`,
  :func:`train_order`, :func:`transform_seed`: the run's seeds and the
  device-resident loader's epoch order (``core/rng.py``,
  ``data/pipeline.py``);
- :func:`k3_eps`: the Philox-4x32-10 draw of K3
  (``ops/fused_elbo.py`` ``k3_eps_plain``);
- :func:`pianoroll_train_transform`: the ``pianoroll`` train transform
  (``data/transforms.py`` ``apply_transform`` with
  ``midi/rasterize.py`` ``augment_pianoroll_batch``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SEED_MODULUS = 0xFFFF_FFFF
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_INV_255 = float(np.float32(1.0 / 255.0))


# ------------------------------------------------------------------ rolls


def make_rolls(generator: torch.Generator, batch: int, pitches: int = 128, steps: int = 128, max_notes: int = 24,
               max_duration: int = 32) -> torch.Tensor:
    """float32 [B, pitches, steps, 1] velocities in [0, 1]: 1..``max_notes``
    notes a roll, each ``duration`` steps from its onset, the louder note
    where two overlap. Drawn on the generator's device."""
    dev = generator.device
    B, N = batch, max_notes
    kw = dict(generator=generator, device=dev)
    num_notes = torch.randint(1, max_notes + 1, (B, 1), **kw)
    active = torch.arange(N, device=dev)[None, :] < num_notes
    pitch = torch.randint(0, pitches, (B, N), **kw)
    onset = torch.randint(0, steps, (B, N), **kw)
    duration = torch.randint(1, max_duration + 1, (B, N), **kw)
    velocity = 0.25 + 0.75 * torch.rand((B, N), **kw)
    tcols = torch.arange(steps, device=dev)[None, None, :]
    tmask = (tcols >= onset[..., None]) & (tcols < (onset + duration)[..., None]) & active[..., None]
    vals = torch.where(tmask, velocity[..., None], 0.0)
    roll = torch.zeros((B, pitches, steps), dtype=torch.float32, device=dev)
    roll.scatter_reduce_(1, pitch[..., None].expand(B, N, steps), vals, reduce="amax", include_self=True)
    return roll[..., None]


def make_corpus(seed: int, n: int, device, chunk: int = 4096) -> torch.Tensor:
    """uint8 [n, 128, 128, 1]: ``n`` rolls drawn from ``seed`` on ``device``
    in chunks, velocities scaled to 0..255 and rounded."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    parts = [(make_rolls(gen, min(chunk, n - i)) * 255.0).round_().to(torch.uint8) for i in range(0, n, chunk)]
    return torch.cat(parts)


# ------------------------------------------------------------------ seeds


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of a run's epoch (``core/rng.py`` ``epoch_seed``)."""
    ss = np.random.SeedSequence([seed % _SEED_MODULUS, epoch, 0x5EED])
    return int(ss.generate_state(1, dtype=np.uint32)[0]) & 0x7FFFFFFF


def step_seed(epoch_seed_: int, step: int) -> int:
    """A SplitMix-style hash of (epoch seed, step) (``derive_step_seed``)."""
    key = (int(epoch_seed_) * 0x9E3779B97F4A7C15 + int(step)) % 2**64
    key = ((key ^ (key >> 31)) * 0xBF58476D1CE4E5B9) % 2**64
    return (key ^ (key >> 32)) & 0x7FFFFFFF


def host_epoch_seed(seed: int, epoch: int) -> int:
    """The seed of an epoch's host shuffle (``host_epoch_seed``, process 0)."""
    ss = np.random.SeedSequence([seed % _SEED_MODULUS, epoch, 0])
    return int(ss.generate_state(1, dtype=np.uint32)[0])


def train_order(seed: int, epoch: int, n: int, batch: int) -> np.ndarray:
    """int64 [n // batch, batch]: the corpus rows of each train batch of an epoch."""
    nb = n // batch
    return np.random.default_rng(host_epoch_seed(seed, epoch)).permutation(n)[: nb * batch].reshape(nb, batch)


def transform_seed(seed: int, epoch: int, batch_idx: int) -> int:
    """The seed of a train batch's random transform."""
    return step_seed(host_epoch_seed(seed, epoch), batch_idx)


# ------------------------------------------------------------------ K3's draw


def _mulhilo32(a: int, b: torch.Tensor):
    t = a * (b >> 16)
    s = ((t & 0xFFFF) << 16) + a * (b & 0xFFFF)
    return (t >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 of counter (c0..c3) under key (k0, k1); words held in int64."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def k3_eps(shape, seed: int, device, offset: int = 0) -> torch.Tensor:
    """The f32 normal noise K3 draws: Philox words 0 and 1 of counter
    (offset + flat index, 0, 0, 0) under key (seed, 0), top 24 bits, Box-Muller."""
    idx = torch.arange(offset, offset + math.prod(shape), dtype=torch.int64, device=device)
    w0, w1, _, _ = philox4x32_10(idx, 0, 0, 0, int(seed), 0)
    u1 = (w0 >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25
    u2 = (w1 >> 8).to(torch.float32) * 2.0**-24
    return (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)).reshape(shape)


# ------------------------------------------------------------------ transform


def pianoroll_train_transform(rolls: torch.Tensor, seed: int, mean: float = 0.5, std: float = 1.0,
                              max_pitch_shift: int = 6, max_time_shift: int = 16,
                              velocity_scale=(0.7, 1.2)) -> torch.Tensor:
    """uint8 [B, P, T, 1] → the normalised, augmented f32 batch: per sample
    a pitch shift, a time shift and a velocity scale drawn from a generator
    seeded with ``seed`` on the rolls' device, the shifted roll scaled and
    clipped to [0, 1], then (x − mean) / std. The crop draws nothing at
    the corpus's own size."""
    x = (rolls.double() * _INV_255).float()
    B, P, T = x.shape[0], x.shape[1], x.shape[2]
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    kw = dict(generator=gen, device=dev)
    dp = torch.randint(-max_pitch_shift, max_pitch_shift + 1, (B,), **kw)
    dt = torch.randint(-max_time_shift, max_time_shift + 1, (B,), **kw)
    lo, hi = velocity_scale
    scale = lo + (hi - lo) * torch.rand((B,), dtype=torch.float32, **kw)
    src_p = torch.arange(P, device=dev)[None, :] - dp[:, None]
    src_t = torch.arange(T, device=dev)[None, :] - dt[:, None]
    keep = ((src_p >= 0) & (src_p < P))[:, :, None] & ((src_t >= 0) & (src_t < T))[:, None, :]
    b_idx = torch.arange(B, device=dev)[:, None, None]
    shifted = x[b_idx, src_p.clamp(0, P - 1)[:, :, None], src_t.clamp(0, T - 1)[:, None, :]]
    shifted = torch.where(keep[..., None], shifted, 0.0)
    x = (shifted * scale.reshape(B, 1, 1, 1)).clamp(0.0, 1.0)
    return ((x - mean) / std).float().contiguous()
