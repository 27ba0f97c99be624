"""Disentanglement metric: the Mutual Information Gap (MIG; Chen et al.
2018, §4.1), counterpart of ``midi_vae_tpu/evaluation/disentanglement.py``.

    MIG = (1/K) Σ_k [ I(z_(j*); v_k) − max_{j≠j*} I(z_j; v_k) ] / H(v_k)

MIG ∈ [0, 1]: 1 when every factor is carried by exactly one latent
coordinate, 0 when it is carried by none or smeared over several. The
representation scored is the posterior mean, collected by an encode sweep
on the device (:func:`encode_means`); the mutual information is the
plug-in (histogram) estimate over equal-width bins per dimension, in
numpy on the host — the same code as the JAX package's. The factors are
the dataset's class labels, or an [N, K] matrix of per-sample factors.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


@torch.inference_mode()
def encode_means(loader, model) -> tuple:
    """Sweep ``loader.epoch(1)`` through the encoder; returns host (mu [N, D]
    f32, y [N]) with the padding rows (``mask == 0``) dropped."""
    mus, ys = [], []
    for batch in loader.epoch(1):
        valid = batch.mask > 0
        mus.append(model.encode(batch.x, train=False).mu[valid].float().cpu().numpy())
        ys.append(batch.y[valid].cpu().numpy())
    return np.concatenate(mus), np.concatenate(ys)


def discretize(codes: np.ndarray, bins: int = 20) -> np.ndarray:
    """Per-dimension equal-width binning of [N, D] floats → int bin ids. A
    constant dimension lands in one bin and carries zero estimated MI."""
    codes = np.asarray(codes, np.float64)
    out = np.empty(codes.shape, np.int64)
    for d in range(codes.shape[1]):
        col = codes[:, d]
        lo, hi = float(col.min()), float(col.max())
        if hi <= lo:  # constant dim: one bin
            out[:, d] = 0
            continue
        edges = np.linspace(lo, hi, bins + 1)[1:-1]
        out[:, d] = np.searchsorted(edges, col, side="right")
    return out


def discrete_entropy(labels: np.ndarray) -> float:
    """Plug-in entropy H(v) in nats of an integer label vector."""
    _, counts = np.unique(np.asarray(labels), return_counts=True)
    p = counts / counts.sum()
    return float(-np.sum(p * np.log(p)))


def discrete_mutual_information(a: np.ndarray, b: np.ndarray) -> float:
    """Plug-in I(a; b) in nats from the joint contingency table."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    joint = np.zeros((ai.max() + 1, bi.max() + 1), np.float64)
    np.add.at(joint, (ai, bi), 1.0)
    joint /= joint.sum()
    pa = joint.sum(axis=1, keepdims=True)
    pb = joint.sum(axis=0, keepdims=True)
    nz = joint > 0
    return float(np.sum(joint[nz] * (np.log(joint[nz]) - np.log((pa * pb)[nz]))))


def mig_score(mu: np.ndarray, factors: np.ndarray, bins: int = 20) -> Dict[str, object]:
    """MIG of representation ``mu`` [N, D] against discrete ``factors`` [N]
    or [N, K]. Returns ``mig`` (the mean over factors), ``mig_per_factor``
    [K], ``mi`` [D, K] (nats), ``factor_entropy`` [K] and ``top_dims`` [K].
    A factor of zero entropy (one class) contributes NaN and is left out
    of the mean; when every factor is, ``mig`` is NaN."""
    mu = np.asarray(mu)
    factors = np.asarray(factors)
    if factors.ndim == 1:
        factors = factors[:, None]
    if mu.shape[0] != factors.shape[0]:
        raise ValueError(f"mu has {mu.shape[0]} samples but factors has {factors.shape[0]}")
    if mu.shape[0] == 0:
        raise ValueError("cannot score an empty representation")

    codes = discretize(mu, bins=bins)
    D, K = mu.shape[1], factors.shape[1]
    mi = np.zeros((D, K))
    for k in range(K):
        for d in range(D):
            mi[d, k] = discrete_mutual_information(codes[:, d], factors[:, k])

    entropy = np.array([discrete_entropy(factors[:, k]) for k in range(K)])
    mig_per_factor = np.full(K, np.nan)
    for k in range(K):
        if entropy[k] <= 0:
            continue  # degenerate factor: MIG undefined
        order = np.sort(mi[:, k])[::-1]
        gap = order[0] - (order[1] if D > 1 else 0.0)
        mig_per_factor[k] = gap / entropy[k]

    finite = mig_per_factor[np.isfinite(mig_per_factor)]
    return {
        "mig": float(finite.mean()) if finite.size else float("nan"),
        "mig_per_factor": mig_per_factor,
        "mi": mi,
        "factor_entropy": entropy,
        "top_dims": mi.argmax(axis=0),
    }


def mig_from_loader(loader, model, bins: int = 20, factors: Optional[np.ndarray] = None) -> Dict[str, object]:
    """Encode a partition and score MIG against its labels (or an explicit
    per-sample ``factors`` matrix in loader order)."""
    mu, y = encode_means(loader, model)
    return mig_score(mu, y if factors is None else factors, bins=bins)
