"""Synthetic data (counterpart of ``midi_vae_tpu/data/synthetic.py``).

- :func:`make_pianoroll_batch`: random note events (pitch, onset,
  duration, velocity) rasterised as horizontal bars, generated on the
  device from an explicit ``torch.Generator``. The stream differs from
  JAX's threefry one; the distribution is the same (notes per roll,
  pitch/onset/duration ranges, velocities in [0.25, 1]).
- :func:`make_lines_batch`: random horizontal and vertical line images
  generated on the device, split into its draws (:func:`lines_draws`,
  from a ``torch.Generator``) and a rasteriser that takes them
  (:func:`rasterize_lines`), so the JAX package's draws can be injected.
- :func:`generate_line_images`: the host line-image factory, the JAX
  package's numpy code, so a seed gives the same images in both packages.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

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


def lines_draws(
    generator: torch.Generator,
    batch_size: int,
    height: int = 128,
    width: int = 128,
    max_lines: int = 20,
    line_width: int = 0,
    full_length: bool = False,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """The random draws of a line batch, int64 tensors on ``device``:
    ``num_lines`` [B, 1] in 1..``max_lines``; per line slot [B, L]:
    ``vertical`` (bool), the band's centre ``pos_v`` (a column) or
    ``pos_h`` (a row), its width ``w`` (1..5, or ``line_width``), and its
    extent ``start_v``/``end_v`` (rows of a vertical line) or
    ``start_h``/``end_h`` (columns of a horizontal one), the whole side
    under ``full_length``. The ranges are the JAX package's
    ``make_lines_batch``'s; the stream is the generator's."""
    dev = resolve_device(device)
    B, L = batch_size, max_lines
    kw = dict(generator=generator, device=dev)
    draws = {
        "num_lines": torch.randint(1, max_lines + 1, (B, 1), **kw),
        "vertical": torch.rand((B, L), **kw) < 0.5,
        "pos_v": torch.randint(0, width, (B, L), **kw),
        "pos_h": torch.randint(0, height, (B, L), **kw),
        "w": torch.randint(1, 6, (B, L), **kw) if line_width == 0 else torch.full((B, L), line_width, device=dev),
    }
    if full_length:
        zeros = torch.zeros((B, L), dtype=torch.int64, device=dev)
        draws.update(start_v=zeros, end_v=zeros + height, start_h=zeros, end_h=zeros + width)
    else:
        for axis, extent in (("v", height), ("h", width)):
            start = torch.randint(0, extent, (B, L), **kw)
            length = torch.randint(0, extent, (B, L), **kw) % torch.clamp(extent - start, min=1)
            draws[f"start_{axis}"], draws[f"end_{axis}"] = start, start + length
    return draws


def rasterize_lines(draws: Dict[str, torch.Tensor], height: int = 128, width: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images float32 [B, H, W, 1] in {0, 1}, line counts [B]) of
    :func:`lines_draws`' draws: each active slot's band of ``w`` around its
    centre over its extent, OR-ed over the slots."""
    num_lines = draws["num_lines"]
    dev = num_lines.device
    L = draws["vertical"].shape[1]
    active = torch.arange(L, device=dev)[None, :] < num_lines  # [B, L]
    rows = torch.arange(height, device=dev).reshape(1, 1, height, 1)
    cols = torch.arange(width, device=dev).reshape(1, 1, 1, width)

    def edge(t):
        return t[:, :, None, None]

    w = draws["w"]
    vlo, vhi = edge(draws["pos_v"] - w // 2), edge(draws["pos_v"] + w // 2 + 1)
    mask_v = (cols >= vlo) & (cols < vhi) & (rows >= edge(draws["start_v"])) & (rows < edge(draws["end_v"]))
    hlo, hhi = edge(draws["pos_h"] - w // 2), edge(draws["pos_h"] + w // 2 + 1)
    mask_h = (rows >= hlo) & (rows < hhi) & (cols >= edge(draws["start_h"])) & (cols < edge(draws["end_h"]))
    line_mask = torch.where(edge(draws["vertical"]), mask_v, mask_h) & edge(active)
    return line_mask.any(dim=1).float()[..., None], num_lines[:, 0]


def make_lines_batch(
    generator: torch.Generator,
    batch_size: int,
    height: int = 128,
    width: int = 128,
    max_lines: int = 20,
    line_width: int = 0,
    full_length: bool = False,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device synthetic line batch (counterpart of the JAX package's
    ``make_lines_batch``): float32 [B, H, W, 1] in {0, 1} and the line
    counts. ``generator`` must live on ``device``."""
    draws = lines_draws(generator, batch_size, height, width, max_lines, line_width, full_length, device)
    return rasterize_lines(draws, height, width)


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
