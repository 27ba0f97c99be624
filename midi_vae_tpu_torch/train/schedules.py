"""Learning-rate and momentum schedules (counterpart of
``midi_vae_tpu/train/schedules.py``).

torch's ``OneCycleLR`` formula (cosine anneal, two phases, ``pct_start``
0.3, ``div_factor`` 25, ``final_div_factor`` 1e4) and its β1
counter-cycle, a constant, a cosine decay to 0 over the run and torch's
``StepLR`` (×``gamma`` every ``step_size`` steps), as pure ``step ->
value`` functions of a host integer step. The optimizer reads them before
each step (``train/optim.py``).

The arithmetic is float32, as in the JAX package: near the start of the
warm-up the formula cancels (``max_lr − 0.96·max_lr``), so a float64
evaluation would differ from the reference by ~1e-6 relative there.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]

_F32 = np.float32


def _annealing_cos(start: float, end: float, pct) -> float:
    """Cosine from ``start`` to ``end`` as ``pct`` goes 0 → 1, in float32."""
    cos_out = np.cos(_F32(np.pi) * _F32(pct)) + _F32(1.0)
    return float(_F32(end) + _F32((start - end) / 2.0) * cos_out)


def _phase_lengths(total_steps: int, pct_start: float):
    up = max(float(pct_start * total_steps) - 1.0, 1.0)
    down = max(float(total_steps - up) - 1.0, 1.0)
    return up, down


def onecycle_lr(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """Rise over ``pct_start·total − 1`` steps from ``max_lr/div_factor`` to
    ``max_lr``, then anneal to ``max_lr/(div_factor·final_div_factor)``."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up, down = _phase_lengths(total_steps, pct_start)

    def sched(step: int) -> float:
        s = min(_F32(step), _F32(total_steps - 1.0))
        if s <= up:
            return _annealing_cos(initial_lr, max_lr, s / _F32(up))
        return _annealing_cos(max_lr, min_lr, (s - _F32(up)) / _F32(down))

    return sched


def onecycle_momentum(
    total_steps: int,
    base_momentum: float = 0.85,
    max_momentum: float = 0.95,
    pct_start: float = 0.3,
) -> Schedule:
    """OneCycle's momentum counter-cycle (β1 of Adam-family optimizers)."""
    up, down = _phase_lengths(total_steps, pct_start)

    def sched(step: int) -> float:
        s = min(_F32(step), _F32(total_steps - 1.0))
        if s <= up:
            return _annealing_cos(max_momentum, base_momentum, s / _F32(up))
        return _annealing_cos(base_momentum, max_momentum, (s - _F32(up)) / _F32(down))

    return sched


def constant_lr(lr: float) -> Schedule:
    def sched(step: int) -> float:
        del step
        return float(lr)

    return sched


def cosine_lr(max_lr: float, total_steps: int, final_lr: float = 0.0) -> Schedule:
    """Cosine from ``max_lr`` at step 0 to ``final_lr`` at ``total_steps``, then flat."""

    def sched(step: int) -> float:
        pct = min(max(_F32(step) / _F32(max(total_steps, 1)), _F32(0.0)), _F32(1.0))
        return _annealing_cos(max_lr, final_lr, pct)

    return sched


def step_decay_lr(max_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """torch ``StepLR``: ``max_lr·gamma^floor(step/step_size)``."""

    def sched(step: int) -> float:
        k = np.floor(_F32(step) / _F32(step_size))
        return float(_F32(max_lr) * _F32(gamma) ** k)

    return sched


def lr_schedule(
    name: str, max_lr: float, total_steps: int, *, step_size: int = 1000, gamma: float = 0.1
) -> Schedule:
    """A named LR schedule (case-insensitive): ``onecycle``, ``constant``,
    ``cosine`` or ``step`` (``step_size`` and ``gamma`` at the JAX
    package's defaults, which the train config does not set)."""
    key = name.lower()
    if key == "onecycle":
        return onecycle_lr(max_lr, total_steps)
    if key == "constant":
        return constant_lr(max_lr)
    if key == "cosine":
        return cosine_lr(max_lr, total_steps)
    if key == "step":
        return step_decay_lr(max_lr, step_size, gamma)
    raise NotImplementedError(f"Scheduler {name} not supported.")
