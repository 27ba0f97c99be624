"""Train state and the train step (counterpart of ``midi_vae_tpu/train/state.py``).

One step is forward → ELBO → backward → AdamW, eagerly. Nothing in it
waits for the device: the schedules and the reparameterization seed are
computed on the host from the host step counter, and the loss terms and
gradient norm come back as device scalars for the caller to read when it
wants them.

Not ported yet: ``grad_accum`` > 1, EMA of the parameters, the β-TC and
VQ objectives.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from midi_vae_tpu_torch.core.types import LossOutput
from midi_vae_tpu_torch.losses.elbo import elbo_loss
from midi_vae_tpu_torch.ops.fused_elbo import fused_elbo_terms
from midi_vae_tpu_torch.train.optim import OptimizerBundle, set_step_hyperparams


@dataclass
class TrainState:
    """The model (parameters and BatchNorm running statistics), its
    optimizer, and ``step``, the number of optimizer steps taken. The step
    updates the model and optimizer in place and returns the state with
    the next step count."""

    model: nn.Module
    optimizer: OptimizerBundle
    step: int = 0


def create_train_state(model: nn.Module, optimizer: OptimizerBundle) -> TrainState:
    """Bundle a built model (parameters already initialised by
    ``build_model``) with its optimizer at step 0."""
    return TrainState(model=model, optimizer=optimizer, step=0)


def derive_step_seed(epoch_seed: int, step: int) -> int:
    """The reparameterization seed of ``step``, in [0, 2**31): a SplitMix-style
    hash of (epoch seed, step) on the host — the counterpart of
    ``fold_in(epoch_key, step)``, with no device work."""
    key = (int(epoch_seed) * 0x9E3779B97F4A7C15 + int(step)) % 2**64
    key = ((key ^ (key >> 31)) * 0xBF58476D1CE4E5B9) % 2**64
    return (key ^ (key >> 32)) & 0x7FFFFFFF


def make_loss(
    *,
    loss_type: str = "elbo",
    fused_loss: bool = False,
    log_var_clamp: Optional[Tuple[float, float]] = None,
    free_bits: Optional[float] = None,
    pos_weight: Optional[float] = None,
    target_denorm=None,
) -> Callable:
    """Build the training objective ``(ModelOutput, kld_weight) → LossOutput``,
    validating option compatibility as midi_vae_tpu/train/state.py:195-206 does."""
    if loss_type not in ("elbo", "beta-tc", "vq"):
        raise ValueError(f"unknown loss_type: {loss_type}")
    if loss_type != "elbo" and fused_loss:
        raise ValueError("fused loss implements the plain ELBO only; drop --fused")
    if free_bits is not None and (fused_loss or loss_type != "elbo"):
        raise ValueError("--free-bits is implemented on the plain (non-fused) ELBO path")
    if loss_type == "vq" and log_var_clamp is not None:
        raise ValueError("--log-var-clamp has no effect on the VQ objective (no posterior variance)")
    if pos_weight is not None and fused_loss:
        raise ValueError("the fused BCE implements the unweighted reference formula; drop --fused for --bce-pos-weight")
    if target_denorm is not None and fused_loss:
        raise ValueError("the fused BCE consumes normalized targets; drop --fused for --bce-targets raw")
    if loss_type != "elbo":
        raise NotImplementedError(f"loss_type={loss_type!r} is not ported to the PyTorch package yet")

    def _loss(out, w: float) -> LossOutput:
        if not fused_loss:
            return elbo_loss(
                out,
                kld_weight=w,
                log_var_clamp=log_var_clamp,
                free_bits=free_bits,
                pos_weight=pos_weight,
                target_denorm=target_denorm,
            )
        lv = out.encoded.log_var
        if log_var_clamp is not None:
            lv = lv.clamp(log_var_clamp[0], log_var_clamp[1])
        loss, recon, kl = fused_elbo_terms(out.logits, out.input, out.encoded.mu, lv, w)
        return LossOutput(
            loss=loss,
            reconstruction_loss=recon.detach(),
            kld_loss=-kl.detach(),
            kl=kl.detach(),
            kld_weight=torch.full((), w, dtype=loss.dtype, device=loss.device),
        )

    return _loss


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def make_train_step(
    kl_schedule: Callable[[int], float],
    *,
    log_var_clamp: Optional[Tuple[float, float]] = None,
    free_bits: Optional[float] = None,
    pos_weight: Optional[float] = None,
    target_denorm=None,
    fused_loss: bool = False,
    loss_type: str = "elbo",
    grad_accum: int = 1,
    ema_decay: Optional[float] = None,
) -> Callable:
    """Build the train step ``(state, x, epoch_seed, *, eps=None) → (state, LossOutput, grad_norm)``.

    ``x`` is an NHWC batch on the model's device. The reparameterization
    seed of each step is :func:`derive_step_seed` of (``epoch_seed``,
    ``state.step``); ``eps`` replaces the draw (tests inject the JAX side's
    noise with it). ``fused_loss=True`` takes the BCE through the K1/K2
    kernels (``ops/fused_elbo.py``). ``grad_norm`` is the global gradient
    norm before clipping.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if grad_accum != 1:
        raise NotImplementedError("grad_accum > 1 is not ported to the PyTorch package yet")
    if ema_decay is not None:
        raise NotImplementedError("EMA parameters are not ported to the PyTorch package yet")
    _loss = make_loss(
        loss_type=loss_type,
        fused_loss=fused_loss,
        log_var_clamp=log_var_clamp,
        free_bits=free_bits,
        pos_weight=pos_weight,
        target_denorm=target_denorm,
    )

    def step(state: TrainState, x: torch.Tensor, epoch_seed: int, *, eps: Optional[torch.Tensor] = None):
        model, bundle = state.model, state.optimizer
        set_step_hyperparams(bundle, state.step)
        model.zero_grad(set_to_none=True)  # also the frozen groups, which are outside the optimizer
        out = model(x, train=True, seed=derive_step_seed(epoch_seed, state.step), eps=eps)
        lo = _loss(out, kl_schedule(state.step))
        lo.loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grad_norm = _global_norm(grads)
        if bundle.grad_clip is not None:
            trainable = [p.grad for g in bundle.optimizer.param_groups for p in g["params"] if p.grad is not None]
            coef = (bundle.grad_clip / _global_norm(trainable)).clamp(max=1.0)
            for g in trainable:
                g.mul_(coef)
        bundle.optimizer.step()
        lo = dataclasses.replace(lo, loss=lo.loss.detach())
        return TrainState(model=model, optimizer=bundle, step=state.step + 1), lo, grad_norm

    return step
