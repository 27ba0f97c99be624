"""Piano-roll rasterization and augmentation (counterpart of
``midi_vae_tpu/midi/rasterize.py``).

- :func:`rasterize_batch` and :func:`rasterize_notes`: padded note arrays
  → [B, P, T, 1] rolls or one [P, T] roll, in torch on any device (a
  max-scatter over (batch, pitch) rows).
- :func:`notes_to_windows`: a parsed file → stacked non-overlapping uint8
  [P, T] windows, in numpy on the host (the corpus-cache path; the JAX
  package's own numpy code, so the windows are bitwise equal).
- :func:`augment_pianoroll_batch`: per-sample pitch shift (vacated rows
  zeroed), time shift (vacated columns zeroed) and velocity scale on a
  batch, in torch on the batch's device. The draws come from a
  ``torch.Generator`` on that device, or are given (tests inject the JAX
  side's); :func:`augment_pianoroll` is the same for one [P, T, C] roll.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from midi_vae_tpu_torch.midi.smf import MAX_PITCH, NoteArrays

DEFAULT_SECONDS_PER_STEP = 0.05  # 20 columns/sec: 128 steps ≈ 6.4 s of music


def rasterize_batch(
    onset_steps: torch.Tensor,  # float32 [B, N] in step units
    duration_steps: torch.Tensor,  # float32 [B, N]
    pitch: torch.Tensor,  # int [B, N]
    velocity: torch.Tensor,  # float32 [B, N] in [0, 1]
    valid: torch.Tensor,  # bool [B, N]: padding mask
    *,
    pitches: int = MAX_PITCH,
    steps: int = 128,
) -> torch.Tensor:
    """Padded note arrays with a leading batch axis → float32 [B, pitches,
    steps, 1] rolls of velocities, in one max-scatter over (batch, pitch)
    rows.

    Overlapping notes on one pitch keep the louder velocity; notes wholly
    outside [0, steps), and notes whose pitch is outside [0, pitches), vanish.
    """
    dev = onset_steps.device
    b = onset_steps.shape[0]
    cols = torch.arange(steps, dtype=torch.float32, device=dev)
    start = onset_steps.float()[..., None]
    end = (onset_steps.float() + duration_steps.float().clamp_min(1.0))[..., None]
    occupied = (cols >= torch.floor(start)) & (cols < torch.ceil(end)) & valid[..., None]
    vel_rows = torch.where(occupied, velocity.float()[..., None], 0.0)  # [B, N, steps]
    # padded notes and pitches off the roll land in an extra row per sample that is dropped
    pitch = pitch.long()
    seg = torch.where(valid & (pitch >= 0) & (pitch < pitches), pitch, pitches)
    seg = seg + torch.arange(b, device=dev)[:, None] * (pitches + 1)
    roll = torch.zeros((b * (pitches + 1), steps), dtype=torch.float32, device=dev)
    roll.scatter_reduce_(0, seg.reshape(-1, 1).expand(-1, steps), vel_rows.reshape(-1, steps), reduce="amax",
                         include_self=True)
    return roll.view(b, pitches + 1, steps)[:, :pitches, :, None]


def rasterize_notes(
    onset_steps: torch.Tensor,  # float32 [N] in step units
    duration_steps: torch.Tensor,  # float32 [N]
    pitch: torch.Tensor,  # int [N]
    velocity: torch.Tensor,  # float32 [N] in [0, 1]
    valid: torch.Tensor,  # bool [N]: padding mask
    *,
    pitches: int = MAX_PITCH,
    steps: int = 128,
) -> torch.Tensor:
    """Padded note arrays → float32 [pitches, steps] roll of velocities
    (:func:`rasterize_batch` of one sample)."""
    notes = (onset_steps, duration_steps, pitch, velocity, valid)
    return rasterize_batch(*(t[None] for t in notes), pitches=pitches, steps=steps)[0, :, :, 0]


def notes_to_windows(
    notes: NoteArrays,
    *,
    pitches: int = MAX_PITCH,
    steps: int = 128,
    seconds_per_step: float = DEFAULT_SECONDS_PER_STEP,
    min_notes_per_window: int = 1,
) -> np.ndarray:
    """Rasterize a parsed file into non-overlapping uint8 windows
    [W, pitches, steps, 1] (velocity 0..127 → 0..255, 0 = silence).

    Only the kept windows are allocated: with ``min_notes_per_window >= 1``
    at most one per note, so a file declaring a huge delta-time cannot make
    ingest allocate a timeline-sized buffer. ``min_notes_per_window=0``
    keeps every window up to the last note's end, budget-capped.
    """
    if len(notes) == 0:
        return np.zeros((0, pitches, steps, 1), np.uint8)
    onset = np.asarray(notes.onset, np.float64)
    duration = np.asarray(notes.duration, np.float64)
    if not (np.isfinite(onset).all() and np.isfinite(duration).all()) or bool((onset < 0).any()):
        raise ValueError("note onsets/durations must be finite and onsets non-negative")
    start_col = np.floor(onset / seconds_per_step).astype(np.int64)
    end_col = np.ceil((onset + np.maximum(duration, 1e-9)) / seconds_per_step).astype(np.int64)
    end_col = np.maximum(end_col, start_col + 1)
    vel = np.clip((notes.velocity.astype(np.float64) / 127.0) * 255.0, 0, 255).astype(np.uint8)
    pit = np.clip(notes.pitch, 0, pitches - 1)

    if min_notes_per_window <= 0:
        n_kept = -(-int(end_col.max()) // steps)
    else:
        ids, counts = np.unique(start_col // steps, return_counts=True)
        kept = ids[counts >= min_notes_per_window]
        n_kept = len(kept)
    if n_kept * pitches * steps > 1 << 31:
        raise ValueError(
            f"rasterization would allocate {n_kept} windows of {pitches}x{steps} (>2 GiB); "
            "the file's timeline is implausibly long for its note count"
        )
    if min_notes_per_window <= 0:
        kept = np.arange(n_kept, dtype=np.int64)

    out = np.zeros((len(kept), pitches, steps, 1), np.uint8)
    # each note paints its clipped span into every kept window it overlaps
    lo = np.searchsorted(kept, start_col // steps, side="left")
    hi = np.searchsorted(kept, (end_col - 1) // steps, side="right")
    for s, e, p, v, a, b in zip(start_col, end_col, pit, vel, lo, hi):
        for k in range(a, b):
            ws = int(kept[k]) * steps
            cs, ce = max(int(s) - ws, 0), min(int(e) - ws, steps)
            if cs < ce:
                row = out[k, p, cs:ce, 0]
                np.maximum(row, v, out=row)
    return out


def augment_pianoroll_batch(
    rolls: torch.Tensor,  # float32 [B, P, T, C] in [0, 1]
    *,
    generator: Optional[torch.Generator] = None,
    max_pitch_shift: int = 6,
    max_time_shift: int = 16,
    velocity_scale: Tuple[float, float] = (0.7, 1.2),
    pitch_shift: Optional[torch.Tensor] = None,
    time_shift: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    rows=None,
) -> torch.Tensor:
    """Per-sample augmentation of a batch: out[b, p, t] = clip(roll[b, p − dp,
    t − dt]·s, 0, 1), zero where p − dp or t − dt falls off the roll.

    dp ∈ [−max_pitch_shift, max_pitch_shift], dt ∈ [−max_time_shift,
    max_time_shift] and s ∈ [velocity_scale) are drawn per sample from
    ``generator`` unless given as ``pitch_shift``/``time_shift``/``scale``
    (int, int and float32 tensors of shape [B]). ``rows`` = (positions,
    global batch) draws over the global batch and keeps those positions
    (``data.transforms.per_sample_draw``).
    """
    from midi_vae_tpu_torch.data.transforms import per_sample_draw

    B, P, T = rolls.shape[0], rolls.shape[1], rolls.shape[2]
    dev = rolls.device
    kw = dict(generator=generator, device=dev)
    if pitch_shift is None:
        pitch_shift = per_sample_draw(lambda s: torch.randint(-max_pitch_shift, max_pitch_shift + 1, s, **kw), B, rows)
    if time_shift is None:
        time_shift = per_sample_draw(lambda s: torch.randint(-max_time_shift, max_time_shift + 1, s, **kw), B, rows)
    if scale is None:
        lo, hi = velocity_scale
        scale = lo + (hi - lo) * per_sample_draw(lambda s: torch.rand(s, dtype=torch.float32, **kw), B, rows)
    src_p = torch.arange(P, device=dev)[None, :] - pitch_shift.to(dev).long()[:, None]  # [B, P]
    src_t = torch.arange(T, device=dev)[None, :] - time_shift.to(dev).long()[:, None]  # [B, T]
    keep = ((src_p >= 0) & (src_p < P))[:, :, None] & ((src_t >= 0) & (src_t < T))[:, None, :]  # [B, P, T]
    flat = (
        torch.arange(B, device=dev)[:, None, None] * (P * T)
        + src_p.clamp(0, P - 1)[:, :, None] * T
        + src_t.clamp(0, T - 1)[:, None, :]
    )
    shifted = rolls.reshape(B * P * T, -1)[flat.reshape(-1)].reshape(rolls.shape)
    shifted = torch.where(keep[..., None], shifted, 0.0)
    return (shifted * scale.to(device=dev, dtype=shifted.dtype).reshape(B, 1, 1, 1)).clamp(0.0, 1.0)


def augment_pianoroll(
    roll: torch.Tensor,  # float32 [P, T, C] in [0, 1]
    *,
    generator: Optional[torch.Generator] = None,
    max_pitch_shift: int = 6,
    max_time_shift: int = 16,
    velocity_scale: Tuple[float, float] = (0.7, 1.2),
    pitch_shift: Optional[int] = None,
    time_shift: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One roll's augmentation (the JAX package's ``augment_pianoroll``):
    :func:`augment_pianoroll_batch` of a batch of one. The pitch shift, time
    shift and velocity scale are drawn from ``generator`` unless given as
    numbers."""
    dev = roll.device
    given = {}
    if pitch_shift is not None:
        given["pitch_shift"] = torch.tensor([int(pitch_shift)], device=dev)
    if time_shift is not None:
        given["time_shift"] = torch.tensor([int(time_shift)], device=dev)
    if scale is not None:
        given["scale"] = torch.tensor([float(scale)], dtype=torch.float32, device=dev)
    return augment_pianoroll_batch(
        roll[None], generator=generator, max_pitch_shift=max_pitch_shift, max_time_shift=max_time_shift,
        velocity_scale=velocity_scale, **given,
    )[0]
