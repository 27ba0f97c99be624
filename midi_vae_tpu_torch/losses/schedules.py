"""KL-weight (β) schedules (counterpart of ``midi_vae_tpu/losses/schedules.py``).

Pure ``step -> weight`` functions of a host integer step, returning
Python floats: PyTorch runs eagerly, so the weight never needs to live on
the device.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def constant(weight: float) -> Schedule:
    def sched(step: int) -> float:
        del step
        return float(weight)

    return sched


def multiplicative(initial: float, growth: float = 1.005, cap: float = 1.0) -> Schedule:
    """``w(t) = min(initial · growth^t, cap)``."""

    def sched(step: int) -> float:
        return min(initial * math.pow(growth, step), cap)

    return sched


def linear_warmup(target: float, warmup_steps: int, initial: float = 0.0) -> Schedule:
    """Linear anneal from ``initial`` to ``target`` over ``warmup_steps``."""

    def sched(step: int) -> float:
        frac = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
        return initial + frac * (target - initial)

    return sched


def cyclical(target: float, period: int, ramp_fraction: float = 0.5) -> Schedule:
    """Within each period, ramp 0 → target over ``ramp_fraction`` of it, then hold."""

    def sched(step: int) -> float:
        pos = (step % period) / period
        return min(max(pos / ramp_fraction, 0.0), 1.0) * target

    return sched


def kl_weight_schedule(
    kind: str = "constant",
    weight: float = 1.0,
    *,
    warmup_steps: int = 1000,
    growth: float = 1.005,
    cap: float = 1.0,
    period: int = 1000,
    ramp_fraction: float = 0.5,
    initial: float = 0.0,
) -> Schedule:
    """Build a β schedule by name: constant | multiplicative | linear | cyclical."""
    kind = kind.lower()
    if kind == "constant":
        return constant(weight)
    if kind == "multiplicative":
        return multiplicative(weight, growth=growth, cap=cap)
    if kind == "linear":
        return linear_warmup(weight, warmup_steps, initial=initial)
    if kind == "cyclical":
        return cyclical(weight, period, ramp_fraction=ramp_fraction)
    raise ValueError(f"Unknown KL schedule kind: {kind}")
