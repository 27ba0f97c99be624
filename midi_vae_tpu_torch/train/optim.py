"""Optimizer construction (counterpart of ``midi_vae_tpu/train/optim.py``):
AdamW with one parameter group per label, per-group peak LR, OneCycle
with β1 cycling, encoder freezing and global-norm clipping. Not ported
yet: the other optimizers (ROADMAP Queue 1 item 17).

optax's ``inject_hyperparams`` evaluates the schedules at the step count
before each update; here :func:`set_step_hyperparams` writes the same
values into the torch parameter groups before each ``optimizer.step()``.
torch's AdamW with ``weight_decay`` passed explicitly (its default is
0.01, optax's 1e-4; the JAX trainer passes 0.0) is optax's ``adamw``:
the same moments, bias corrections with the current β1, and decoupled
decay.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from midi_vae_tpu_torch.train.schedules import Schedule, lr_schedule, onecycle_momentum

_ADAM_B2 = 0.999  # optax and torch default
BASE_BATCH_SIZE = 128  # the CLI's --lr is per this batch size


def scale_lr(lr_relative: float, global_batch_size: int) -> float:
    """Linear LR scaling with the global batch size."""
    return lr_relative * global_batch_size / BASE_BATCH_SIZE


class OptimizerBundle(NamedTuple):
    optimizer: torch.optim.Optimizer
    lr_schedules: Dict[str, Schedule]  # group name → schedule, for the groups being trained
    b1_schedule: Optional[Schedule]  # OneCycle β1 cycle, or None for a fixed β1
    grad_clip: Optional[float]  # global-norm clip over the trainable parameters


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
    their gradients, which count in the logged norm as in the JAX step).
    """
    if optimizer.lower() != "adamw":
        raise NotImplementedError(f"optimizer {optimizer} is not ported to the PyTorch package yet (AdamW only)")
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
            continue
        schedules[group] = lr_schedule(scheduler, lr * mult, total_steps)
        if group_params[group]:
            groups.append({"params": group_params[group], "name": group})
    opt = torch.optim.AdamW(
        groups, lr=schedules["decoder"](0), betas=(b1(0) if b1 else 0.9, _ADAM_B2), weight_decay=weight_decay
    )
    return OptimizerBundle(opt, schedules, b1, grad_clip or None)


def set_step_hyperparams(bundle: OptimizerBundle, step: int) -> None:
    """Write each group's scheduled LR (and the cycled β1) for ``step``."""
    for group in bundle.optimizer.param_groups:
        group["lr"] = bundle.lr_schedules[group["name"]](step)
        if bundle.b1_schedule is not None:
            group["betas"] = (bundle.b1_schedule(step), group["betas"][1])
