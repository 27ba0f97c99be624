"""Optimizer construction (counterpart of ``midi_vae_tpu/train/optim.py``):
one parameter group per label with its own peak LR and schedule, OneCycle's
β1 cycle, encoder freezing and global-norm clipping, over the optimizer
named as torch names them (AdamW, Adam, SGD, RMSprop, Adagrad, LAMB, Lion).

optax's ``inject_hyperparams`` evaluates the schedules at the step count
before each update; here :func:`set_step_hyperparams` writes the same
values into the torch parameter groups before each ``optimizer.step()``.
AdamW is torch's, with ``weight_decay`` passed explicitly (its default is
0.01, optax's 1e-4; the JAX trainer passes its own): optax's ``adamw``, the
same moments, bias corrections with the current β1, and decoupled decay.
The other six follow optax's update rules, not torch's classes
(:class:`OptaxRule` and its subclasses), with optax's defaults, each held
in f32 as ``inject_hyperparams`` holds them:

- ``adam``: b2 0.999, ε 1e-8 outside the root; a nonzero ``weight_decay``
  is ``add_decayed_weights`` chained before it (coupled L2);
- ``sgd``: plain, with a trace ``t = g + m·t`` only while OneCycle's β1
  cycle drives the momentum; decay chained before it as for Adam;
- ``rmsprop``: decay 0.9, ε 1e-8 inside the root, initial scale 0;
- ``adagrad``: accumulator from 0.1, ε 1e-7 inside the root, no decay;
- ``lamb``: Adam's moments (b1 0.9, b2 0.999, ε 1e-6), then the decay, then
  each tensor's trust ratio ‖p‖/‖u‖ (1 where either norm is 0);
- ``lion``: sign((1 − b1)·g + b1·m) with b1 0.9, m updated at b2 0.99, then
  the decay.

Only adamw, adam and sgd take the cycled β1, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from midi_vae_tpu_torch.train.schedules import Schedule, lr_schedule, onecycle_momentum

_ADAM_B2 = 0.999  # optax and torch default
BASE_BATCH_SIZE = 128  # the CLI's --lr is per this batch size


def scale_lr(lr_relative: float, global_batch_size: int) -> float:
    """Linear LR scaling with the global batch size."""
    return lr_relative * global_batch_size / BASE_BATCH_SIZE


class OptimizerBundle(NamedTuple):
    optimizer: torch.optim.Optimizer
    lr_schedules: Dict[str, Schedule]  # group name → schedule (a frozen group's is 0.0)
    b1_schedule: Optional[Schedule]  # OneCycle β1 cycle, or None for a fixed β1
    grad_clip: Optional[float]  # global-norm clip over the trainable parameters


class OptaxRule(torch.optim.Optimizer):
    """An optimizer whose update is optax's: :meth:`directions` maps a
    group's gradients to their updates u (before the learning rate), and
    the step applies ``p ← p + (−lr)·u`` in f32, as ``scale_by_learning_rate``
    and ``apply_updates`` do. Each rule works on the group's tensor lists
    with ``torch._foreach_*``, one launch per operation for the whole group
    as AdamW's foreach path; no operation fuses two roundings that optax
    keeps apart. Hyperparameters live in the groups (``lr``, ``b1``,
    ``weight_decay``), where :func:`set_step_hyperparams` writes the
    scheduled ones."""

    def __init__(self, params, *, lr: float, b1: Optional[float] = None, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, weight_decay=weight_decay))

    def directions(self, ps: List[torch.Tensor], gs: List[torch.Tensor], states: List[dict], group: dict) -> list:
        """The updates for ``ps``; never writes into ``gs`` (they may be the gradients themselves)."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if ps:
                us = self.directions(ps, [p.grad.float() for p in ps], [self.state[p] for p in ps], group)
                torch._foreach_add_(ps, torch._foreach_mul(us, -float(group["lr"])))


def _f32(x: float) -> float:
    """``x`` rounded to f32: ``inject_hyperparams`` holds every numeric
    hyperparameter (b1, b2, ε, decays, initial values) as an f32 array."""
    return float(np.float32(x))


def _one_minus(decay: float) -> float:
    """1 − decay, computed in f32 as optax computes it from the injected decay."""
    return float(np.float32(1.0) - np.float32(decay))


def _decayed(gs: list, ps: list, weight_decay: float) -> list:
    """``add_decayed_weights``: g + wd·p (``gs`` itself when wd is 0)."""
    return torch._foreach_add(gs, torch._foreach_mul(ps, _f32(weight_decay))) if weight_decay else gs


def _ema_(buf: list, gs: list, decay: float, square: bool = False) -> None:
    """buf ← decay·buf + (1 − decay)·g (or g²), in optax's order of roundings."""
    torch._foreach_mul_(buf, _f32(decay))
    torch._foreach_add_(buf, torch._foreach_mul(torch._foreach_mul(gs, gs) if square else gs, _one_minus(decay)))


def _state(states: list, gs: list, name: str, fill: float = 0.0) -> list:
    """Each tensor's ``name`` buffer, made as ``fill`` at its first step."""
    return [s[name] if name in s else s.setdefault(name, torch.full_like(g, fill)) for s, g in zip(states, gs)]


def _adam_directions(gs: list, states: list, b1: float, eps: float) -> list:
    """``scale_by_adam`` (b2 0.999, eps_root 0): bias-corrected m / (√v + ε).
    All tensors of a group step together, so they share one count."""
    for s in states:
        s["count"] = s.get("count", 0) + 1
    count = np.float32(states[0]["count"])
    mu, nu = _state(states, gs, "mu"), _state(states, gs, "nu")
    _ema_(mu, gs, b1)
    _ema_(nu, gs, _ADAM_B2, square=True)
    mu_hat = torch._foreach_div(mu, float(np.float32(1.0) - np.float32(b1) ** count))
    denom = torch._foreach_sqrt(torch._foreach_div(nu, float(np.float32(1.0) - np.float32(_ADAM_B2) ** count)))
    torch._foreach_add_(denom, _f32(eps))
    return torch._foreach_div(mu_hat, denom)


class Adam(OptaxRule):
    """optax ``adam`` with coupled L2 decay chained before it."""

    def directions(self, ps, gs, states, group):
        return _adam_directions(_decayed(gs, ps, group["weight_decay"]), states, group["b1"], 1e-8)


class SGD(OptaxRule):
    """optax ``sgd``: a momentum trace only when ``b1`` is set."""

    def directions(self, ps, gs, states, group):
        us = _decayed(gs, ps, group["weight_decay"])
        if group["b1"] is None:
            return us
        trace = _state(states, us, "trace")
        torch._foreach_mul_(trace, _f32(group["b1"]))
        torch._foreach_add_(trace, us)
        return trace


class RMSprop(OptaxRule):
    """optax ``rmsprop``: ν ← 0.9·ν + 0.1·g², u = g / √(ν + 1e-8)."""

    def directions(self, ps, gs, states, group):
        gs = _decayed(gs, ps, group["weight_decay"])
        nu = _state(states, gs, "nu")
        _ema_(nu, gs, 0.9, square=True)
        scale = torch._foreach_add(nu, _f32(1e-8))
        torch._foreach_rsqrt_(scale)
        return torch._foreach_mul(scale, gs)


class Adagrad(OptaxRule):
    """optax ``adagrad``: Σg² from 0.1, u = g / √(Σg² + 1e-7). The sum
    never falls below 0.1, so optax's guard against a zero sum is left out."""

    def directions(self, ps, gs, states, group):
        acc = _state(states, gs, "sum_of_squares", _f32(0.1))
        torch._foreach_add_(acc, torch._foreach_mul(gs, gs))
        scale = torch._foreach_add(acc, _f32(1e-7))
        torch._foreach_rsqrt_(scale)
        return torch._foreach_mul(scale, gs)


class LAMB(OptaxRule):
    """optax ``lamb``: Adam's direction, the decay, then each tensor's trust ratio."""

    def directions(self, ps, gs, states, group):
        us = _decayed(_adam_directions(gs, states, 0.9, 1e-6), ps, group["weight_decay"])
        p_norm = torch.stack(torch._foreach_norm(ps)).float()
        u_norm = torch.stack(torch._foreach_norm(us))
        ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
        return torch._foreach_mul(us, list(ratio.unbind()))


class Lion(OptaxRule):
    """optax ``lion``: sign((1 − 0.9)·g + 0.9·m), m ← 0.99·m + 0.01·g, then the decay."""

    def directions(self, ps, gs, states, group):
        mu = _state(states, gs, "mu")
        us = torch._foreach_add(torch._foreach_mul(gs, _one_minus(0.9)), torch._foreach_mul(mu, _f32(0.9)))
        torch._foreach_sign_(us)
        _ema_(mu, gs, 0.99)
        return _decayed(us, ps, group["weight_decay"])


# name → (class, whether the OneCycle β1 cycle drives it)
OPTAX_RULES = {"adam": (Adam, True), "sgd": (SGD, True), "rmsprop": (RMSprop, False),
               "adagrad": (Adagrad, False), "lamb": (LAMB, False), "lion": (Lion, False)}


def build_optimizer(
    model: torch.nn.Module,
    label_fn: Callable[[str], str],
    *,
    optimizer: str = "AdamW",
    lr: float = 0.01,
    lr_encoder_mult: float = 1.0,
    lr_decoder_mult: float = 1.0,
    weight_decay: float = 0.0,
    scheduler: str = "OneCycle",
    total_steps: int = 1000,
    freeze_encoder: bool = False,
    cycle_momentum: bool = True,
    grad_clip: Optional[float] = None,
) -> OptimizerBundle:
    """Build the grouped optimizer over ``model``'s parameters.

    ``label_fn`` maps a dotted parameter name to "encoder" or "decoder".
    A frozen encoder's parameters are left out of the optimizer (they keep
    their gradients, which count in the logged norm as in the JAX step);
    its schedule is the constant 0.0, which the loop logs as ``lr-encoder``.
    """
    key = optimizer.lower()
    if key != "adamw" and key not in OPTAX_RULES:
        raise ValueError(f"Unsupported optimizer: {optimizer}")
    if grad_clip is not None and grad_clip < 0:
        raise ValueError(f"grad_clip must be positive, got {grad_clip}")
    b1 = onecycle_momentum(total_steps) if (scheduler.lower() == "onecycle" and cycle_momentum) else None

    group_params: Dict[str, list] = {"encoder": [], "decoder": []}
    for name, p in model.named_parameters():
        group_params[label_fn(name)].append(p)
    group_mults = {"encoder": lr_encoder_mult, "decoder": lr_decoder_mult}
    schedules: Dict[str, Schedule] = {}
    groups = []
    for group, mult in group_mults.items():
        if group == "encoder" and freeze_encoder:
            # logged at 0.0, as the JAX package keeps a frozen group in its LR log
            schedules[group] = lr_schedule("constant", 0.0, total_steps)
            continue
        schedules[group] = lr_schedule(scheduler, lr * mult, total_steps)
        if group_params[group]:
            groups.append({"params": group_params[group], "name": group})
    lr0 = schedules["decoder"](0)
    if key == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr0, betas=(b1(0) if b1 else 0.9, _ADAM_B2), weight_decay=weight_decay)
    else:
        cls, cycled = OPTAX_RULES[key]
        if not cycled:
            b1 = None
        default_b1 = None if key == "sgd" else 0.9  # optax's sgd has no momentum unless given one
        # adagrad takes no weight decay in the JAX package
        opt = cls(groups, lr=lr0, b1=b1(0) if b1 else default_b1, weight_decay=0.0 if key == "adagrad" else weight_decay)
    return OptimizerBundle(opt, schedules, b1, grad_clip or None)


def set_step_hyperparams(bundle: OptimizerBundle, step: int) -> None:
    """Write each group's scheduled LR (and the cycled β1) for ``step``."""
    for group in bundle.optimizer.param_groups:
        group["lr"] = bundle.lr_schedules[group["name"]](step)
        if bundle.b1_schedule is not None:
            if "betas" in group:
                group["betas"] = (bundle.b1_schedule(step), group["betas"][1])
            else:
                group["b1"] = bundle.b1_schedule(step)
