"""The numbers that decide ``correct``: what the port's timed path produced
against what the plain reference works out, over the first three steps of
the run's own training object.

- ``loss1``, ``loss2``, ...: each step's |loss − reference loss| /
  |reference loss|, and ``loss`` the worst of them;
- ``kl1``, ``kl2``, ...: the same of each step's KL term (the positive
  Gaussian KL before its weight, which the reference works out whatever
  the weight), and ``kl`` the worst;
- ``beta``: the worst |weight − reference weight| of the KL term over the
  steps, over the largest reference weight of those steps (the KL
  schedule, warm-up included);
- ``grad``: over the leaves, the worst |‖g‖ − ‖g_ref‖| of the first
  gradient as the optimizer got it, over the larger of ‖g_ref‖ of that
  leaf and of the median leaf;
- ``change``: the same of the parameters' change after the steps, over
  the leaves whose reference gradient, in f32, is at least a thousandth of
  the median leaf's (a conv bias under BatchNorm gets a gradient of
  rounding alone, which Adam turns into a step of ±lr on either side);
  ``change_median`` is the median leaf's gap, which the learning rate sets.
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

FLAT_GRAD = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's is left out of ``change``


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _worst_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def _relative(prog, ref) -> list:
    return [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref)]


def moved_leaves(rule_grads: Dict[str, torch.Tensor]) -> list:
    """The leaves whose gradient in ``rule_grads`` (the reference's first
    step in f32, where no rounding stands in for a gradient) is at least
    :data:`FLAT_GRAD` of the median leaf's."""
    g = _norms(rule_grads)
    med = statistics.median(g.values())
    return sorted(k for k in g if g[k] >= FLAT_GRAD * med)


def train_numbers(prog: dict, ref: dict, p0: Dict[str, torch.Tensor], moved: list) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses``, ``kls`` and ``kl_weights`` (one a
    step), ``first_grads`` and ``params`` (after the last step), name →
    tensor; ``p0`` the parameters both started from; ``moved`` the leaves
    the change is taken over."""
    n = len(ref["losses"])
    if any(len(prog[k]) != n or len(ref[k]) != n for k in ("losses", "kls", "kl_weights")):
        raise ValueError("the two sides ran different numbers of steps")
    losses, kls = _relative(prog["losses"], ref["losses"]), _relative(prog["kls"], ref["kls"])
    w_top = max(max(abs(w) for w in ref["kl_weights"]), 1e-30)
    beta = max(abs(a - b) for a, b in zip(prog["kl_weights"], ref["kl_weights"])) / w_top
    g_ref = _norms(ref["first_grads"])
    grad = _worst_gap(_norms(prog["first_grads"]), g_ref, sorted(g_ref))
    d_prog = _norms({k: prog["params"][k].double() - p0[k].double() for k in moved})
    d_ref = _norms({k: ref["params"][k].double() - p0[k].double() for k in moved})
    med = statistics.median(d_ref.values())
    gaps = sorted(abs(d_prog[k] - d_ref[k]) / max(d_ref[k], med, 1e-30) for k in moved)
    out = {"loss": max(losses), "kl": max(kls), "beta": beta, "grad": grad, "change": gaps[-1],
           "change_median": statistics.median(gaps)}
    out.update({f"loss{i + 1}": v for i, v in enumerate(losses)})
    out.update({f"kl{i + 1}": v for i, v in enumerate(kls)})
    return out
