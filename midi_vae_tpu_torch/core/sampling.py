"""Ancestral sampling of VQ code grids (counterpart of the sampler in
``midi_vae_tpu/models/prior.py``).

:func:`sample_codes_autoregressive` takes any prior callable
``prior(idx, y) → logits [B, s, s, K]``: the live ``nn.Module`` of
``models/prior.py`` or the exported ``prior_logits`` program of
``interop/aot_export.py``. It imports no model code, so the artifact
loader draws with the same loop as the checkpoint server: one seed gives
the same codes from either. :func:`nucleus_mask` restricts a draw to its
top-p nucleus.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from midi_vae_tpu_torch.core.rng import categorical


def nucleus_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask ``[N, K]`` logits to their nucleus (the smallest set of codes
    with cumulative probability ≥ ``top_p``); the rest become −inf. The
    descending order is a stable sort, as ``jnp.argsort``: equal
    probabilities keep index order."""
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(-probs, dim=-1, stable=True).indices
    sorted_probs = torch.gather(probs, -1, order)
    # keep a sorted position while the mass before it is < top_p: always the top-1 code
    keep_sorted = torch.cumsum(sorted_probs, dim=-1) - sorted_probs < top_p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, -math.inf))


@torch.inference_mode()
def sample_codes_autoregressive(
    prior: Callable,
    seed: int,
    num_samples: int,
    grid: int,
    temperature: float = 1.0,
    y: Optional[torch.Tensor] = None,
    top_p: Optional[float] = None,
    known: Optional[torch.Tensor] = None,
    known_mask=None,
    *,
    device: Optional[torch.device] = None,
    num_codes: Optional[int] = None,
) -> torch.Tensor:
    """Ancestral sampling: [num_samples, grid, grid] int32 code grids on the
    prior's device, one full forward ``prior(idx, y)`` per raster position.

    ``device`` and ``num_codes`` default to the prior module's parameters'
    device and its ``num_codes``; a bare callable passes both. ``seed``
    keys a ``torch.Generator`` on that device. ``top_p`` restricts each
    draw to the nucleus (:func:`nucleus_mask`; ≥ 1 is a no-op). ``known``
    [num_samples, grid, grid] with ``known_mask`` [grid, grid] forces the
    masked positions to their known codes (exact p(rest | prefix) for a
    raster prefix, forced decoding otherwise). Every position consumes its
    draw whether it is forced or not, so free positions before the first
    forced one equal an unconstrained run with the same seed; a forced
    position skips the forward it does not need.
    """
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if (known is None) != (known_mask is None):
        raise ValueError("known and known_mask must be provided together")
    dev = device if device is not None else next(prior.parameters()).device
    num_codes = num_codes if num_codes is not None else prior.num_codes
    forced = np.zeros((grid, grid), bool)
    if known is not None:
        known = torch.as_tensor(known, device=dev).long()
        forced = np.asarray(torch.as_tensor(known_mask).cpu(), bool)
        if tuple(known.shape) != (num_samples, grid, grid):
            raise ValueError(f"known must be [num_samples={num_samples}, {grid}, {grid}], got {tuple(known.shape)}")
        if forced.shape != (grid, grid):
            raise ValueError(f"known_mask must be [{grid}, {grid}], got {forced.shape}")
    if y is not None:
        y = torch.as_tensor(y, device=dev).long()
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    t_inv = float(np.float32(1.0) / np.maximum(np.float32(temperature), np.float32(1e-6)))
    use_nucleus = top_p is not None and top_p < 1.0
    idx = torch.zeros((num_samples, grid, grid), dtype=torch.long, device=dev)
    for t in range(grid * grid):
        i, j = divmod(t, grid)
        if forced[i, j]:
            torch.rand((num_samples, num_codes), generator=gen, device=dev)  # the draw this position consumes
            idx[:, i, j] = known[:, i, j]
            continue
        step_logits = prior(idx, y)[:, i, j, :].float() * t_inv
        if use_nucleus:
            step_logits = nucleus_mask(step_logits, float(top_p))
        idx[:, i, j] = categorical(step_logits, gen)
    return idx.int()
