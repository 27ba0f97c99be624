"""Synthetic MIDI dataset factory (a copy of ``midi_vae_tpu/midi/factory.py``:
the same seed writes the same files in both packages).

Two generators share one SMF-writing contract:

- :func:`random_notes` — chord-free uniform note soup (pitch, onset and
  duration all independent draws).
- :func:`structured_notes` — tonal, metric, phrased music: a key and
  scale, a chord progression on a bar grid, a small-step scale-degree
  melody quantized to a 16th-note metric grid, and a repeated 2-bar
  phrase.

Files are written in a class-per-subdirectory tree (classes =
note-density buckets). The tree feeds ``data/sources.py:load_midi_folder``
→ parse → rasterize → RRD cache, the full MIDI ingestion path.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from midi_vae_tpu_torch.midi.smf import NoteArrays, write_smf


def random_notes(
    rng: np.random.Generator,
    n_notes: int,
    *,
    length_seconds: float = 8.0,
    pitch_range: Tuple[int, int] = (21, 109),  # piano compass A0..C8
    duration_range: Tuple[float, float] = (0.1, 1.5),
    velocity_range: Tuple[int, int] = (32, 127),
) -> NoteArrays:
    """Draw a random note-event sequence (uniform onsets, pitches, durations)."""
    onset = np.sort(rng.uniform(0.0, length_seconds, n_notes))
    duration = rng.uniform(*duration_range, n_notes)
    pitch = rng.integers(*pitch_range, n_notes).astype(np.int32)
    velocity = rng.integers(velocity_range[0], velocity_range[1] + 1, n_notes).astype(np.int32)
    return NoteArrays(onset=onset, duration=duration, pitch=pitch, velocity=velocity)


# -- tonal/metric/phrased generator ------------------------------------------

#: scale templates as semitone offsets from the tonic
MAJOR_SCALE = (0, 2, 4, 5, 7, 9, 11)
MINOR_SCALE = (0, 2, 3, 5, 7, 8, 10)
#: 4-bar chord progressions as scale degrees (I-V-vi-IV and friends)
PROGRESSIONS = ((0, 4, 5, 3), (0, 3, 4, 4), (0, 5, 3, 4), (5, 3, 0, 4))
#: 16th-note durations (seconds) whose raster at 0.05 s/col is an integer
#: number of columns (3, 4, 5) — keeps the metric grid visible post-raster
GRID_SECONDS = (0.15, 0.20, 0.25)


def structured_notes(
    rng: np.random.Generator,
    *,
    length_seconds: float = 8.0,
    notes_per_bar: int = 8,
    velocity_range: Tuple[int, int] = (48, 112),
) -> NoteArrays:
    """Draw one tonal, metric, phrased piece.

    Structure knobs a statistic can catch:

    - **key/scale**: every pitch is drawn from one (tonic, mode) scale —
      per-roll scale consistency ≈ 1.0 (random corpus ≈ 0.75).
    - **metric grid**: onsets sit on a 16th-note grid, melody durations
      are 1/2/4 grid steps — inter-onset intervals concentrate on grid
      multiples.
    - **chord progression**: one triad per bar from a 4-bar progression,
      held for the bar — polyphony floor of 3, harmonic intervals of
      thirds/fifths.
    - **melody**: scale-degree random walk, steps mostly ±1/±2 degrees —
      pitch-interval distribution concentrates on ≤4 semitones.
    - **phrase repeat**: bars 3-4 replay bars 1-2's melody (possibly
      shifted one scale degree) — self-similarity along time.
    """
    tonic = 48 + int(rng.integers(0, 12))  # C3..B3 tonic
    scale = MAJOR_SCALE if rng.random() < 0.5 else MINOR_SCALE
    grid = float(rng.choice(GRID_SECONDS))  # one 16th note, in seconds
    bar = 16 * grid  # 4/4, sixteen 16ths per bar
    n_bars = max(2, int(length_seconds / bar))
    progression = PROGRESSIONS[int(rng.integers(0, len(PROGRESSIONS)))]

    def degree_pitch(deg: int, octave: int = 0) -> int:
        return tonic + 12 * (octave + deg // 7) + scale[deg % 7]

    onsets, durations, pitches, velocities = [], [], [], []

    def emit(t: float, dur: float, pitch: int, vel: int) -> None:
        onsets.append(t)
        durations.append(dur)
        pitches.append(int(np.clip(pitch, 0, 127)))
        velocities.append(int(np.clip(vel, 1, 127)))

    # -- harmony: one held triad per bar ---------------------------------
    for b in range(n_bars):
        deg = progression[b % len(progression)]
        t = b * bar
        for voice in (0, 2, 4):  # root, third, fifth
            emit(t, bar * 0.95, degree_pitch(deg + voice), int(rng.integers(*velocity_range)))

    # -- melody: 2-bar phrase, repeated with optional degree shift -------
    def draw_phrase() -> list:
        """[(grid_slot, n_grid_steps, scale_degree, strong)] over 2 bars."""
        events, slot, deg = [], 0, 7 + int(rng.integers(0, 7))  # melody octave
        total_slots = 32  # 2 bars of 16ths
        target = 2 * notes_per_bar
        while slot < total_slots and len(events) < target:
            dur_steps = int(rng.choice((1, 2, 2, 4)))
            strong = slot % 4 == 0
            events.append((slot, dur_steps, deg, strong))
            deg += int(rng.choice((-2, -1, -1, 1, 1, 2)))  # small scale steps
            deg = int(np.clip(deg, 7, 20))
            slot += dur_steps + (0 if rng.random() < 0.8 else 1)  # mostly legato
        return events

    phrase = draw_phrase()
    for rep in range(int(np.ceil(n_bars / 2))):
        shift = 0 if rep % 2 == 0 else int(rng.integers(-1, 2))  # varied repeat
        t0 = rep * 2 * bar
        if t0 >= length_seconds:
            break
        for slot, dur_steps, deg, strong in phrase:
            t = t0 + slot * grid
            if t + grid > length_seconds:
                break
            vel = int(rng.integers(*velocity_range)) + (12 if strong else 0)
            emit(t, dur_steps * grid * 0.95, degree_pitch(deg + shift), vel)

    order = np.argsort(np.asarray(onsets))
    return NoteArrays(
        onset=np.asarray(onsets, np.float64)[order],
        duration=np.asarray(durations, np.float64)[order],
        pitch=np.asarray(pitches, np.int32)[order],
        velocity=np.asarray(velocities, np.int32)[order],
    )


def generate_midi_dataset(
    n_files: int,
    path: str,
    *,
    max_notes: int = 48,
    length_seconds: float = 8.0,
    density_classes: int = 4,
    seed: Optional[int] = 0,
    style: str = "random",
) -> int:
    """Write ``n_files`` .mid files under ``path`` in density-bucket
    class folders ``{path}/{k}_density/file_{i}.mid``; returns files written.

    Mirrors ``generate_line_images``'s contract (count, path, class
    subdirs, deterministic seed) with MIDI in place of PNGs.

    ``style="random"`` draws uniform note soup (:func:`random_notes`);
    ``style="structured"`` draws tonal/metric/phrased pieces
    (:func:`structured_notes`), with the density bucket mapping to the
    melody's notes-per-bar instead of a raw note count.
    """
    if style not in ("random", "structured"):
        raise ValueError(f"unknown style {style!r}: expected 'random' or 'structured'")
    rng = np.random.default_rng(seed)
    written = 0
    for i in range(n_files):
        bucket = int(rng.integers(0, density_classes))
        if style == "structured":
            notes = structured_notes(
                rng, length_seconds=length_seconds, notes_per_bar=4 + 2 * bucket
            )
        else:
            lo = 1 + bucket * max_notes // density_classes
            hi = (bucket + 1) * max_notes // density_classes
            n_notes = int(rng.integers(lo, max(hi, lo) + 1))
            notes = random_notes(rng, n_notes, length_seconds=length_seconds)
        class_dir = os.path.join(path, f"{bucket}_density")
        os.makedirs(class_dir, exist_ok=True)
        write_smf(notes, os.path.join(class_dir, f"file_{i + 1}.mid"))
        written += 1
    return written
