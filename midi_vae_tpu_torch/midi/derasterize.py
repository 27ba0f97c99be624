"""Piano-roll → MIDI export, the inverse of :mod:`midi.rasterize`
(counterpart of ``midi_vae_tpu/midi/derasterize.py``, the same numpy code).

Turns generated or reconstructed rolls back into Standard MIDI Files so
model samples can be listened to. Used by the generation CLI
(``cli/generate.py --export-midi``).
"""

from __future__ import annotations

import numpy as np

from midi_vae_tpu_torch.midi.rasterize import DEFAULT_SECONDS_PER_STEP
from midi_vae_tpu_torch.midi.smf import NoteArrays


def roll_to_notes(
    roll: np.ndarray,
    *,
    seconds_per_step: float = DEFAULT_SECONDS_PER_STEP,
    threshold: float = 0.1,
) -> NoteArrays:
    """Extract note events from a [P, T] (or [P, T, 1]) velocity roll.

    Each maximal run of above-threshold cells in a pitch row becomes one
    note; velocity is the run's peak value mapped back to 1..127.
    """
    roll = np.asarray(roll)
    if roll.ndim == 3:
        roll = roll[..., 0]
    if roll.dtype == np.uint8:
        roll = roll.astype(np.float64) / 255.0
    P, T = roll.shape

    active = roll > threshold
    # run boundaries per row: diff of the padded activity mask
    padded = np.zeros((P, T + 2), bool)
    padded[:, 1:-1] = active
    d = np.diff(padded.astype(np.int8), axis=1)
    rows, starts = np.nonzero(d == 1)
    rows_e, ends = np.nonzero(d == -1)
    if len(rows) != len(rows_e):
        raise AssertionError("unbalanced note runs")

    onset, duration, pitch, velocity = [], [], [], []
    for r, s, e in zip(rows, starts, ends):
        onset.append(s * seconds_per_step)
        duration.append((e - s) * seconds_per_step)
        pitch.append(r)
        velocity.append(int(np.clip(round(roll[r, s:e].max() * 127), 1, 127)))
    order = np.argsort(onset, kind="stable")
    return NoteArrays(
        onset=np.asarray(onset, np.float64)[order],
        duration=np.asarray(duration, np.float64)[order],
        pitch=np.asarray(pitch, np.int32)[order],
        velocity=np.asarray(velocity, np.int32)[order],
    )
