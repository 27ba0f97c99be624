"""Inference entry points: prior sampling, reconstruction, latent
interpolation and traversal (counterpart of
``midi_vae_tpu/evaluation/inference.py``).

Plain functions on a model of this package, each under
``torch.inference_mode()`` (which is per thread: a caller on another
thread gets it by calling these). They run the model with ``train=False``
as an argument and never switch the module's mode, so threads may share
one model.

Draws are keyed by a seed through a CPU ``torch.Generator`` and copied to
the model's device once: one seed gives one z on the CPU and on the card.
``z`` and ``eps`` replace the draw (tests inject the JAX side's).
Conditional models take int labels ``y`` (:func:`label_kwarg`).

JAX ``vmap``s the decode over interpolation steps and traversal offsets;
here the [steps, B, D] latents are decoded as one [steps·B, D] batch,
which is the same result because an eval-mode BatchNorm acts per sample.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from midi_vae_tpu_torch.models.vae import label_kwarg


def normal_draw(shape, seed: int, device) -> torch.Tensor:
    """An f32 N(0, I) draw of ``shape`` keyed by ``seed``: drawn on the CPU,
    then copied to ``device``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen).to(device)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _decode_steps(model, zs: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode [..., D] latents as one batch; returns [..., H, W, C]. Labels
    ``y`` cover the trailing batch axis (one label covers all) and repeat
    over the leading ones."""
    if y is not None:
        y = y.reshape(-1).repeat(zs[..., 0].numel() // y.numel())
    flat = model.decode(zs.reshape(-1, zs.shape[-1]), train=False, **label_kwarg(model, y))
    return flat.reshape(*zs.shape[:-1], *flat.shape[1:])


@torch.inference_mode()
def sample_prior(
    model, num_samples: int, seed: int = 0, *, z: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Decode ``num_samples`` prior draws z ~ N(0, I); returns [n, H, W, C]
    probabilities on the model's device. A conditional model needs ``y``
    (int [n]), the class of each sample. A VQ model (``latent_kind ==
    "vq"``) has no Gaussian prior: it decodes code grids drawn from its EMA
    usage marginal instead (``VQVAE.sample``)."""
    if getattr(model, "latent_kind", "gaussian") == "vq":
        return model.sample(num_samples, seed)
    dev = _device(model)
    if z is None:
        z = normal_draw((num_samples, model.latent_dim), seed, dev)
    return model.decode(z.to(dev), train=False, **label_kwarg(model, None if y is None else y.to(dev)))


@torch.inference_mode()
def reconstruct(
    model, x: torch.Tensor, seed: int = 0, *, eps: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Reconstruct NHWC ``x`` through one posterior draw (the model's
    forward in eval mode, as the JAX package's ``reconstruct``; a VQ
    model's forward ignores the draw)."""
    if eps is None:
        eps = normal_draw((x.shape[0], model.latent_dim), seed, x.device)
    return model(x, train=False, eps=eps.to(x.device), **label_kwarg(model, None if y is None else y.to(x.device))).output


def _slerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation along the great circle between latent vectors."""
    a_n = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
    b_n = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
    omega = torch.arccos(torch.clamp(torch.sum(a_n * b_n, dim=-1, keepdim=True), -1 + 1e-7, 1 - 1e-7))
    so = torch.sin(omega)
    return (torch.sin((1.0 - t) * omega) / so) * a + (torch.sin(t * omega) / so) * b


def latent_path(mu_a: torch.Tensor, mu_b: torch.Tensor, steps: int, mode: str) -> torch.Tensor:
    """[steps, B, D] latents from ``mu_a`` to ``mu_b`` ([B, D] each), ``lerp``
    or ``slerp``, endpoints included."""
    ts = torch.linspace(0.0, 1.0, steps, device=mu_a.device).reshape(steps, 1, 1)
    if mode == "lerp":
        return (1.0 - ts) * mu_a[None] + ts * mu_b[None]
    if mode == "slerp":
        return _slerp(mu_a, mu_b, ts)
    raise ValueError(f"Unknown interpolation mode: {mode}")


@torch.inference_mode()
def interpolate(
    model, x_a: torch.Tensor, x_b: torch.Tensor, *, steps: int = 8, mode: str = "lerp", y: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Encode two batches, interpolate between their posterior means and
    decode the path; returns [steps, B, H, W, C]. A conditional model
    encodes both ends and decodes every step under the labels ``y`` [B]."""
    y = None if y is None else y.to(x_a.device)
    mu_a = model.encode(x_a, train=False, **label_kwarg(model, y)).mu
    mu_b = model.encode(x_b, train=False, **label_kwarg(model, y)).mu
    return _decode_steps(model, latent_path(mu_a, mu_b, steps, mode), y)


@torch.inference_mode()
def traverse(
    model, x: torch.Tensor, *, steps: int = 8, span: float = 2.5, y: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Latent traversal of the first input: each latent dimension varied
    across ±``span`` posterior σ while the others stay at the posterior
    mean; returns [latent_dim, steps, H, W, C]. A conditional model
    traverses under the first label of ``y``."""
    y1 = None if y is None else y.reshape(-1)[:1].to(x.device)
    enc = model.encode(x[:1], train=False, **label_kwarg(model, y1))
    mu = enc.mu[0]
    sigma = torch.exp(0.5 * enc.log_var[0])
    d = mu.shape[0]
    offsets = torch.linspace(-span, span, steps, device=mu.device)
    # [D, S, D]: dimension d varied by offsets·σ_d, the others at mu
    deltas = torch.eye(d, device=mu.device)[:, None, :] * (offsets[None, :, None] * sigma[None, None, :])
    return _decode_steps(model, mu[None, None, :] + deltas, y1)


def reconstruction_grid(stimuli: torch.Tensor, reconstructions: torch.Tensor, pairs: int = 8) -> torch.Tensor:
    """Input|reconstruction pairs of up to ``pairs`` NHWC samples, four
    pairs a row, as one [H', W', C] image."""
    n = min(pairs, stimuli.shape[0])
    paired = torch.cat([stimuli[:n], reconstructions[:n]], dim=2)  # widthwise pairs
    rows = [torch.cat(list(paired[i : i + 4]), dim=1) for i in range(0, n, 4)]
    width = max(r.shape[1] for r in rows)
    rows = [F.pad(r, (0, 0, 0, width - r.shape[1])) for r in rows]
    return torch.cat(rows, dim=0)
