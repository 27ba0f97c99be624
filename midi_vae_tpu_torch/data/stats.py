"""Corpus statistics for the "auto" loss and initialisation settings
(counterpart of ``midi_vae_tpu/data/stats.py``, the same numpy code).

The base rate p is the raw fill rate of the train corpus (mean pixel in
[0, 1], before normalisation):

- ``--output-bias-init auto`` → decoder output bias log(p/(1−p));
- ``--bce-pos-weight auto`` → positive-class weight (1−p)/p.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_P_MIN, _P_MAX = 1e-4, 1.0 - 1e-4


def estimate_base_rate(dataset, max_samples: int = 4096, seed: int = 0) -> float:
    """Mean pixel value in [0, 1] of a row sample of ``dataset``."""
    rng = np.random.default_rng(seed)
    images = dataset.images
    n = len(images)
    sample = images[np.sort(rng.choice(n, size=max_samples, replace=False))] if n > max_samples else images
    x = sample.astype(np.float64)
    if sample.dtype == np.uint8:
        x = x / 255.0
    return float(np.clip(x.mean(), _P_MIN, _P_MAX))


def base_rate_logit(p: float) -> float:
    """log(p/(1−p)): the constant logit whose sigmoid is the base rate."""
    p = float(np.clip(p, _P_MIN, _P_MAX))
    return float(np.log(p / (1.0 - p)))


def pos_weight_from_base_rate(p: float) -> float:
    """(1−p)/p: equalises the two classes' total BCE mass."""
    p = float(np.clip(p, _P_MIN, _P_MAX))
    return float((1.0 - p) / p)


def resolve_auto(value, dataset, what: str, base_rate: Optional[float] = None) -> Optional[float]:
    """None, a float, or "auto" resolved against the corpus: ``what`` is
    "bias" (:func:`base_rate_logit`) or "pos_weight"
    (:func:`pos_weight_from_base_rate`); pass one shared ``base_rate`` to
    sweep the corpus once."""
    if value is None:
        return None
    if value == "auto":
        p = base_rate if base_rate is not None else estimate_base_rate(dataset)
        out = base_rate_logit(p) if what == "bias" else pos_weight_from_base_rate(p)
        print(f"auto {what}: corpus base rate p={p:.5f} -> {out:.4f}")
        return out
    return float(value)
