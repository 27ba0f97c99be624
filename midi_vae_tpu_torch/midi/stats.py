"""Corpus-level musical statistics of binary piano-rolls (counterpart of
``midi_vae_tpu/midi/stats.py``, the same numpy code).

The statistics a musician would notice about a corpus, as normalised
histograms, and the Jensen-Shannon divergence that compares two corpora.
The export-threshold calibrator (:mod:`midi.calibrate`) scores candidate
thresholds with them. Two tiers:

- first order (``STAT_KEYS``): note density, pitch-class usage,
  polyphony, note duration;
- second order (``STAT_KEYS_2ND``): inter-onset intervals, melodic and
  harmonic pitch intervals, per-roll best-fit scale consistency.
"""

from __future__ import annotations

import numpy as np

#: note-duration histogram bin edges (columns), log-spaced; the last bin
#: absorbs arbitrarily long runs
DUR_BINS = np.array([1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 48, 64, 96, 1_000_000])
#: polyphony histogram covers 0..16+ simultaneous pitches
POLY_MAX = 16
#: per-roll density histogram: 1.3%-fill corpora live well under 6%
DENSITY_BINS = np.linspace(0.0, 0.06, 25)

#: inter-onset-interval histogram bin edges (columns), log-spaced
IOI_BINS = np.array([1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 48, 64, 1_000_000])
#: pitch intervals are clipped to ±2 octaves (bin per semitone)
PITCH_INTERVAL_MAX = 24
#: per-roll best-fit scale membership: 7-of-12 templates floor at 7/12
SCALE_FIT_BINS = np.linspace(0.5, 1.0, 21)

STAT_KEYS = ("density", "pitch_class", "polyphony", "duration")
STAT_KEYS_2ND = ("ioi", "pitch_interval", "scale_consistency")

#: the 24 binary key templates [24, 12]: 12 major + 12 minor rotations
_MAJOR = (0, 2, 4, 5, 7, 9, 11)
_MINOR = (0, 2, 3, 5, 7, 8, 10)
SCALE_TEMPLATES = np.zeros((24, 12), np.float64)
for _tonic in range(12):
    SCALE_TEMPLATES[_tonic, [(_tonic + s) % 12 for s in _MAJOR]] = 1.0
    SCALE_TEMPLATES[12 + _tonic, [(_tonic + s) % 12 for s in _MINOR]] = 1.0


def run_lengths(rolls: np.ndarray) -> np.ndarray:
    """All note durations (run lengths of 1s along the time axis) in a
    binary [N, H, W] roll stack."""
    n, h, w = rolls.shape
    pad = np.zeros((n, h, 1), rolls.dtype)
    d = np.diff(np.concatenate([pad, rolls, pad], axis=2).astype(np.int8), axis=2)
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    # row-major flatnonzero: within each (n, h) row, starts/ends alternate
    # in order, so the k-th end closes the k-th start
    return ends - starts


def onset_events(rolls: np.ndarray):
    """Note-start events of a binary [N, H, W] roll stack as flat arrays
    ``(roll_index, pitch_row, column)``, sorted by (roll, column, pitch)."""
    prev = np.concatenate([np.zeros_like(rolls[:, :, :1]), rolls[:, :, :-1]], axis=2)
    ni, hi, wi = np.nonzero((rolls == 1) & (prev == 0))
    order = np.lexsort((hi, wi, ni))  # roll-major, then time, then pitch
    return ni[order], hi[order], wi[order]


def roll_statistics(rolls: np.ndarray) -> dict:
    """Corpus-level musical statistics of a binary [N, H, W] roll stack:
    normalised histograms per statistic (first and second order) and
    scalar summaries."""
    rolls = np.asarray(rolls, np.uint8)
    n, h, w = rolls.shape
    density = rolls.mean(axis=(1, 2))  # [N]
    # clip into the last bin so off-scale generations still count (np.histogram
    # drops out-of-range values, which would distort the normalisation)
    dens_hist, _ = np.histogram(np.clip(density, 0, DENSITY_BINS[-1] - 1e-9), bins=DENSITY_BINS)

    pitch_rows = rolls.sum(axis=(0, 2), dtype=np.int64)  # [H] active cells per pitch
    pc = np.zeros(12, np.int64)
    np.add.at(pc, np.arange(h) % 12, pitch_rows)

    poly = rolls.sum(axis=1)  # [N, W] active pitches per column
    poly_hist, _ = np.histogram(np.minimum(poly, POLY_MAX), bins=np.arange(POLY_MAX + 2))

    durs = run_lengths(rolls)
    dur_hist, _ = np.histogram(durs, bins=DUR_BINS)

    # -- second order -----------------------------------------------------
    ni, hi, wi = onset_events(rolls)

    # inter-onset intervals: gaps between distinct onset columns within a roll
    same_roll = ni[1:] == ni[:-1]
    col_diff = wi[1:] - wi[:-1]
    ioi = col_diff[same_roll & (col_diff > 0)]
    ioi_hist, _ = np.histogram(ioi, bins=IOI_BINS)

    # pitch intervals between consecutive onset events, clipped to ±2 octaves
    pint = (hi[1:] - hi[:-1])[same_roll]
    pint = np.clip(pint, -PITCH_INTERVAL_MAX, PITCH_INTERVAL_MAX)
    pint_hist, _ = np.histogram(pint, bins=np.arange(-PITCH_INTERVAL_MAX - 0.5,
                                                     PITCH_INTERVAL_MAX + 1.5))

    # per-roll key consistency: fraction of active-cell mass inside the
    # best of the 24 major/minor scale templates (floor 7/12 for noise)
    pc_per_roll = np.zeros((n, 12), np.float64)
    rows = rolls.sum(axis=2, dtype=np.int64)  # [N, H] active cells per pitch row
    np.add.at(pc_per_roll.T, np.arange(h) % 12, rows.T.astype(np.float64))
    mass = pc_per_roll.sum(axis=1)
    nonempty = mass > 0
    fit = (pc_per_roll @ SCALE_TEMPLATES.T)[nonempty].max(axis=1) / mass[nonempty]
    fit_hist, _ = np.histogram(np.clip(fit, SCALE_FIT_BINS[0], SCALE_FIT_BINS[-1] - 1e-9),
                               bins=SCALE_FIT_BINS)

    def norm(hist):
        s = hist.sum()
        return (hist / s) if s > 0 else np.full(len(hist), 1.0 / len(hist))

    return {
        "density": norm(dens_hist),
        "pitch_class": norm(pc),
        "polyphony": norm(poly_hist),
        "duration": norm(dur_hist),
        "ioi": norm(ioi_hist),
        "pitch_interval": norm(pint_hist),
        "scale_consistency": norm(fit_hist),
        "mean_density": float(density.mean()),
        "mean_polyphony": float(poly.mean()),
        "mean_duration": float(durs.mean()) if len(durs) else 0.0,
        "notes_per_roll": float(len(durs) / max(n, 1)),
        "mean_ioi": float(ioi.mean()) if len(ioi) else 0.0,
        "mean_abs_pitch_interval": float(np.abs(pint).mean()) if len(pint) else 0.0,
        "mean_scale_fit": float(fit.mean()) if nonempty.any() else 0.0,
    }


def js_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """Jensen-Shannon divergence, base 2 (0 = identical, 1 = disjoint)."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    m = 0.5 * (p + q)

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def js_profile(stats: dict, ref: dict) -> dict:
    """Per-statistic JS divergences of one corpus against a reference, and
    their means: ``js_mean`` over the first-order statistics,
    ``js_mean_2nd`` over the second-order ones when both sides carry them."""
    out = {f"js_{k}": round(js_divergence(stats[k], ref[k]), 4) for k in STAT_KEYS}
    out["js_mean"] = round(float(np.mean([out[f"js_{k}"] for k in STAT_KEYS])), 4)
    if all(k in stats and k in ref for k in STAT_KEYS_2ND):
        for k in STAT_KEYS_2ND:
            out[f"js_{k}"] = round(js_divergence(stats[k], ref[k]), 4)
        out["js_mean_2nd"] = round(
            float(np.mean([out[f"js_{k}"] for k in STAT_KEYS_2ND])), 4
        )
    return out
