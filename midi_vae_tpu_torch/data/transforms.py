"""Transform stacks on the batch's device (counterpart of
``midi_vae_tpu/data/transforms.py``).

uint8 NHWC batches cross to the device as they are; scaling, piano-roll
augmentation, resize, crop, normalisation and grayscale then run there as
torch ops. Stacks (``get_transform``):

- ``noaug``: Resize(shortest→S) → RandomCrop(S) (train) / CenterCrop (eval)
  → scale [0, 1] → Normalize
- ``midi``: the same + Grayscale last
- ``digits``: Resize → CenterCrop → scale → Normalize (train and eval)
- ``pianoroll``: pitch/time shift and velocity scale (train), then as
  ``noaug``

The normalisation table is mean 0.5 / std 1.0, so pixels land in
[−0.5, 0.5]. The resize is torch's bilinear with antialiasing, which
approximates ``jax.image.resize``; the stacks the shipped configs run
never resize (the images already have the configured size), and there the
result is bitwise the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NORMALIZATION = {
    "mnist": ((0.5,), (1.0,)),
    "vae-lines": ((0.5,), (1.0,)),
    "vae-lines-large": ((0.5,), (1.0,)),
    "vae-lines-synthetic": ((0.5,), (1.0,)),
    "vae-lines-large-synthetic": ((0.5,), (1.0,)),
    "pianoroll-synthetic": ((0.5,), (1.0,)),
    "midi-synthetic": ((0.5,), (1.0,)),
    "midi-structured": ((0.5,), (1.0,)),
    "midi-folder": ((0.5,), (1.0,)),
}

VALID_TRANSFORMS = list(NORMALIZATION.keys())

_LUMA = (0.2989, 0.587, 0.114)  # ITU-R 601, as torchvision Grayscale()
_INV_255 = float(np.float32(1.0 / 255.0))


@dataclasses.dataclass(frozen=True)
class TransformSpec:
    """A static description of one transform stack."""

    image_size: int = 32
    mean: Tuple[float, ...] = (0.5,)
    std: Tuple[float, ...] = (1.0,)
    random_crop: bool = False  # False → center crop
    grayscale: bool = False
    pianoroll_augment: bool = False  # applied before normalisation, in [0, 1]
    max_pitch_shift: int = 6
    max_time_shift: int = 16
    velocity_scale: Tuple[float, float] = (0.7, 1.2)


def get_transform(transform_type: str = "noaug", image_size: int = 32, args: Optional[dict] = None):
    """(train_spec, eval_spec) for a named stack."""
    if args is None:
        args = {}
    mean, std = NORMALIZATION[args.get("normalization", "mnist")]
    mean = tuple(args.get("mean", mean))
    std = tuple(args.get("std", std))
    if transform_type == "noaug":
        train = TransformSpec(image_size, mean, std, random_crop=True)
        test = TransformSpec(image_size, mean, std, random_crop=False)
    elif transform_type == "midi":
        train = TransformSpec(image_size, mean, std, random_crop=True, grayscale=True)
        test = TransformSpec(image_size, mean, std, random_crop=False, grayscale=True)
    elif transform_type == "digits":
        train = TransformSpec(image_size, mean, std, random_crop=False)
        test = TransformSpec(image_size, mean, std, random_crop=False)
    elif transform_type == "pianoroll":
        train = TransformSpec(image_size, mean, std, random_crop=True, pianoroll_augment=True)
        test = TransformSpec(image_size, mean, std, random_crop=False)
    else:
        raise NotImplementedError(f"Unknown transform type: {transform_type}")
    return train, test


def _resize_shortest(x: torch.Tensor, target: int) -> torch.Tensor:
    """Resize NHWC so the shortest spatial side equals ``target`` (aspect kept)."""
    _, h, w, _ = x.shape
    if min(h, w) == target:
        return x
    scale = target / min(h, w)
    nh, nw = max(target, round(h * scale)), max(target, round(w * scale))
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def _center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    _, h, w, _ = x.shape
    top, left = (h - size) // 2, (w - size) // 2
    return x[:, top : top + size, left : left + size, :]


def per_sample_draw(draw, b: int, rows=None) -> torch.Tensor:
    """``draw(shape)`` of one value per sample of a batch of ``b``; with
    ``rows`` = (positions, global batch), the draw over the global batch at
    those positions (a rank's rows of a data-parallel batch)."""
    if rows is None:
        return draw((b,))
    positions, total = rows
    out = draw((total,))
    return out[positions.to(out.device)]


def _random_crop(x: torch.Tensor, size: int, generator: Optional[torch.Generator], rows=None) -> torch.Tensor:
    """Per-sample random square crop (torchvision RandomCrop semantics)."""
    b, h, w, _ = x.shape
    if h == size and w == size:
        return x
    tops = per_sample_draw(lambda s: torch.randint(0, h - size + 1, s, generator=generator, device=x.device), b, rows)
    lefts = per_sample_draw(lambda s: torch.randint(0, w - size + 1, s, generator=generator, device=x.device), b, rows)
    rows = (tops[:, None] + torch.arange(size, device=x.device)[None, :])[:, :, None]  # [b, size, 1]
    cols = (lefts[:, None] + torch.arange(size, device=x.device)[None, :])[:, None, :]  # [b, 1, size]
    return x[torch.arange(b, device=x.device)[:, None, None], rows, cols]


def _per_channel(values, x: torch.Tensor):
    """A per-channel constant for NHWC ``x``: a Python float for one channel
    (no host-to-device copy per batch), else a [1, 1, 1, C] tensor."""
    if len(values) == 1:
        return float(values[0])
    return torch.tensor(values, dtype=x.dtype, device=x.device).reshape(1, 1, 1, -1)


def apply_transform(spec: TransformSpec, batch: torch.Tensor, seed: Optional[int] = None, rows=None) -> torch.Tensor:
    """Apply a transform stack to a uint8/float NHWC batch on its device.

    uint8 is scaled to [0, 1]; float input is taken as already in [0, 1].
    ``seed`` keys the stack's random parts (augmentation, random crop)
    through a ``torch.Generator`` on the batch's device; ``None`` runs the
    deterministic parts only, as the JAX package does without a key.
    ``rows`` = (positions, global batch) draws them over a global batch and
    keeps this batch's positions (:func:`per_sample_draw`).
    """
    # uint8 → [0, 1] as the JAX package's compiled stack computes it: a
    # multiply by the f32 reciprocal of 255, fused with the normalisation
    # (one rounding). The product is exact in f64, so it stays f64 until
    # the normalisation rounds it once; augmentation and resize take f32.
    x = batch.double() * _INV_255 if batch.dtype == torch.uint8 else batch.float()
    gen = None
    if seed is not None and (spec.pianoroll_augment or spec.random_crop):
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
    if spec.pianoroll_augment and gen is not None:
        from midi_vae_tpu_torch.midi.rasterize import augment_pianoroll_batch

        x = augment_pianoroll_batch(
            x.float(), generator=gen, max_pitch_shift=spec.max_pitch_shift,
            max_time_shift=spec.max_time_shift, velocity_scale=spec.velocity_scale, rows=rows,
        )
    x = _resize_shortest(x, spec.image_size)
    if spec.random_crop and gen is not None:
        x = _random_crop(x, spec.image_size, gen, rows)
    else:
        x = _center_crop(x, spec.image_size)
    x = ((x - _per_channel(spec.mean, x)) / _per_channel(spec.std, x)).float()
    if spec.grayscale and x.shape[-1] == 3:
        # after Normalize, as the reference's stack
        luma = torch.tensor(_LUMA, dtype=torch.float32, device=x.device).reshape(1, 1, 1, 3)
        x = torch.sum(x * luma, dim=-1, keepdim=True)
    return x.contiguous()


def denormalize_with(mean, std, x: torch.Tensor) -> torch.Tensor:
    """``x·std + mean`` with per-channel broadcasting over NHWC."""
    return x * _per_channel(std, x) + _per_channel(mean, x)


def denormalize(spec: TransformSpec, x: torch.Tensor) -> torch.Tensor:
    """Invert the normalisation (image logging, BCE targets in [0, 1])."""
    return denormalize_with(spec.mean, spec.std, x)
