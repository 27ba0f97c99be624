"""Synthetic data (counterpart of ``midi_vae_tpu/data/synthetic.py``).

- :func:`make_pianoroll_batch`: random note events (pitch, onset,
  duration, velocity) rasterised as horizontal bars, generated on the
  device from an explicit ``torch.Generator``. The stream differs from
  JAX's threefry one; the distribution is the same (notes per roll,
  pitch/onset/duration ranges, velocities in [0.25, 1]).
- :func:`generate_line_images`: the host line-image factory, the JAX
  package's numpy code, so a seed gives the same images in both packages.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
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


def _draw_line(img: np.ndarray, rng: np.random.Generator, line_width: int, full_length: bool) -> None:
    height, width = img.shape
    is_vertical = bool(rng.integers(0, 2))
    w = int(rng.integers(1, 6)) if line_width == 0 else line_width
    if is_vertical:
        x = int(rng.integers(0, width))
        if full_length:
            start_y, end_y = 0, height
        else:
            start_y = int(rng.integers(0, height))
            end_y = int(rng.integers(start_y, height))
        img[start_y:end_y, max(0, x - w // 2) : min(width, x + w // 2 + 1)] = 255
    else:
        y = int(rng.integers(0, height))
        if full_length:
            start_x, end_x = 0, width
        else:
            start_x = int(rng.integers(0, width))
            end_x = int(rng.integers(start_x, width))
        img[max(0, y - w // 2) : min(height, y + w // 2 + 1), start_x:end_x] = 255


def generate_line_images(
    num_images: int,
    img_size: Tuple[int, int] = (28, 28),
    max_lines: int = 2,
    line_width: int = 2,
    full_length: bool = True,
    filter_duplicates: bool = True,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 [N, H, W] in {0, 255}, labels int64 [N] = line count):
    1..``max_lines`` random horizontal or vertical lines per image,
    duplicates dropped and topped up; warns when the unique-image space runs
    out before ``num_images``."""
    rng = np.random.default_rng(seed)
    height, width = img_size
    images, labels = [], []
    seen = set()
    attempts = 0
    while len(images) < num_images and attempts < num_images * 20:
        attempts += 1
        img = np.zeros((height, width), dtype=np.uint8)
        num_lines = int(rng.integers(1, max_lines + 1))
        for _ in range(num_lines):
            _draw_line(img, rng, line_width, full_length)
        if filter_duplicates:
            fingerprint = img.tobytes()
            if fingerprint in seen:
                continue
            seen.add(fingerprint)
        images.append(img)
        labels.append(num_lines)
    if len(images) < num_images:
        warnings.warn(
            f"generate_line_images: unique-image space exhausted at {len(images)}/"
            f"{num_images} after {attempts} attempts; returning the smaller set",
            UserWarning,
            stacklevel=2,
        )
    if not images:
        return np.zeros((0, height, width), np.uint8), np.zeros(0, np.int64)
    return np.stack(images), np.asarray(labels, dtype=np.int64)
