"""Deterministic dataset splitting (counterpart of ``midi_vae_tpu/data/splits.py``).

- :func:`random_train_test_split`: the seeded 80/20 split of folder and
  synthetic datasets, the same indices as the JAX package's for a seed.
- :func:`create_train_val_split`: K-fold prototyping splits with
  ``split_seed = int(split_id · split_rate)`` and ``fold_id = split_id %
  n_splits``, through scikit-learn's (Stratified)KFold, imported when a
  prototyping split is asked for.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np


def random_train_test_split(n: int, ratio: float = 0.8, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled index split: first ``int(ratio·n)`` to train, rest to test."""
    perm = np.random.default_rng(seed).permutation(n)
    train_size = int(ratio * n)
    return perm[:train_size], perm[train_size:]


def create_train_val_split(
    n: int,
    labels: Optional[np.ndarray] = None,
    split_rate: float = 0.1,
    split_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """K-fold train/val split over ``range(n)``; stratified by ``labels`` when given."""
    import sklearn.model_selection

    n_splits = round(1.0 / split_rate)
    if n_splits < 2:
        raise ValueError(
            f"protoval split rate {split_rate} implies {n_splits} K-fold split(s); "
            "K-fold needs >= 2 (use a split rate <= 2/3)"
        )
    if (1.0 / n_splits) != split_rate:
        warnings.warn(
            "The requested train/val split rate is not possible when using"
            f" K folds. The actual split rate will be {1.0 / n_splits}"
            f" instead of {split_rate}.",
            UserWarning,
            stacklevel=2,
        )
    split_seed = int(split_id * split_rate)
    fold_id = split_id % n_splits
    if labels is None:
        warnings.warn("Creating prototyping splits without stratification.", UserWarning, stacklevel=2)
        splitter = sklearn.model_selection.KFold(n_splits=n_splits, shuffle=True, random_state=split_seed)
    else:
        splitter = sklearn.model_selection.StratifiedKFold(n_splits=n_splits, shuffle=True, random_state=split_seed)
    for i, (train_indices, val_indices) in enumerate(splitter.split(np.arange(n), labels)):
        if i == fold_id:
            return train_indices, val_indices
    raise AssertionError("unreachable: fold_id < n_splits by construction")
