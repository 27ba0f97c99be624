"""Export-threshold calibration: fit the roll → MIDI binarisation threshold
to a checkpoint (counterpart of ``midi_vae_tpu/midi/calibrate.py``, the
same numpy code).

:func:`midi.derasterize.roll_to_notes` turns each maximal run of
above-threshold cells into one note. A decoder's probabilities sag
mid-note, so a fixed threshold splits long notes into several short ones.
The calibration sweeps candidate thresholds over the model's own
reconstructions of real rolls and picks the one whose note-event
statistics (:mod:`midi.stats`) sit closest to the real corpus's, scored as
the mean Jensen-Shannon divergence. Used by ``cli/generate.py
--export-threshold auto``.
"""

from __future__ import annotations

import numpy as np

from midi_vae_tpu_torch.midi.stats import STAT_KEYS, js_divergence, roll_statistics

#: default candidate grid: log-spaced through the plausible range of a
#: sigmoid decoder's output; 0.1 (the fixed default) included
DEFAULT_GRID = (0.02, 0.03, 0.05, 0.07, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5)


def calibrate_export_threshold(
    recon_probs: np.ndarray,
    target_rolls: np.ndarray,
    thresholds=DEFAULT_GRID,
    target_threshold: float = 0.1,
):
    """Pick the export threshold whose thresholded reconstructions best
    match the targets' note-event statistics.

    ``recon_probs``: decoded probabilities [N, H, W] (or [N, H, W, 1]) in
    [0, 1]; ``target_rolls``: the matching real rolls in raw [0, 1] space,
    binarised at ``target_threshold``. Returns ``(best_threshold, rows)``:
    the threshold of least mean JS divergence and the per-candidate score
    table (``threshold``, ``js_mean``, per-statistic JS,
    ``mean_duration``, ``notes_per_roll``).
    """
    recon_probs = np.asarray(recon_probs)
    target_rolls = np.asarray(target_rolls)
    if recon_probs.ndim == 4:  # [N, H, W, 1] channel-last decoder output
        recon_probs = recon_probs[..., 0]
    if target_rolls.ndim == 4:
        target_rolls = target_rolls[..., 0]
    ref = roll_statistics((target_rolls > target_threshold).astype(np.uint8))

    rows = []
    for t in thresholds:
        st = roll_statistics((recon_probs > t).astype(np.uint8))
        js = {f"js_{k}": round(js_divergence(st[k], ref[k]), 4) for k in STAT_KEYS}
        rows.append({
            "threshold": float(t),
            **js,
            "js_mean": round(float(np.mean(list(js.values()))), 4),
            "mean_duration": round(st["mean_duration"], 2),
            "notes_per_roll": round(st["notes_per_roll"], 1),
        })
    best = min(rows, key=lambda r: r["js_mean"])
    return best["threshold"], rows
