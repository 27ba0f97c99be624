"""On-device synthetic piano-roll batches (counterpart of
``make_pianoroll_batch`` in ``midi_vae_tpu/data/synthetic.py``).

Random note events (pitch, onset, duration, velocity) rasterised as
horizontal bars, generated on the device from an explicit
``torch.Generator``. The stream differs from JAX's threefry one; the
distribution is the same (notes per roll, pitch/onset/duration ranges,
velocities in [0.25, 1]).
"""

from __future__ import annotations

from typing import Tuple

import torch

from midi_vae_tpu_torch.core.device import DeviceLike, resolve_device


def make_pianoroll_batch(
    generator: torch.Generator,
    batch_size: int,
    pitches: int = 128,
    steps: int = 128,
    max_notes: int = 24,
    max_duration: int = 32,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rolls, note counts): float32 ``[B, pitches, steps, 1]`` velocities in
    [0, 1] and int64 ``[B]``. ``generator`` must live on ``device``.

    Each roll has 1..``max_notes`` notes; a note covers ``duration`` in
    1..``max_duration`` steps from its onset (cut at the roll's end). Where
    notes overlap, the louder velocity wins.
    """
    dev = resolve_device(device)
    B, N = batch_size, max_notes
    kw = dict(generator=generator, device=dev)
    num_notes = torch.randint(1, max_notes + 1, (B, 1), **kw)
    active = torch.arange(N, device=dev)[None, :] < num_notes  # [B, N]
    pitch = torch.randint(0, pitches, (B, N), **kw)
    onset = torch.randint(0, steps, (B, N), **kw)
    duration = torch.randint(1, max_duration + 1, (B, N), **kw)
    velocity = 0.25 + 0.75 * torch.rand((B, N), **kw)

    tcols = torch.arange(steps, device=dev)[None, None, :]  # [1, 1, T]
    tmask = (tcols >= onset[..., None]) & (tcols < (onset + duration)[..., None]) & active[..., None]
    vals = torch.where(tmask, velocity[..., None], 0.0)  # [B, N, T]
    # max-scatter each note's time profile into its pitch row
    roll = torch.zeros((B, pitches, steps), dtype=torch.float32, device=dev)
    roll.scatter_reduce_(1, pitch[..., None].expand(B, N, steps), vals, reduce="amax", include_self=True)
    return roll[..., None], num_notes[:, 0]
