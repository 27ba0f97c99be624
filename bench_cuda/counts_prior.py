"""Operations and bytes of the stage-2 prior cell (Moonlight-16B-A3B's
block, ``reference/moonlight_prior.py``), whatever implements it.

- :func:`step_flops`: the model FLOPs (2 a multiply-add) of one training
  step, forward and backward (the backward twice the forward): every
  matmul of the reference's step, with causal attention counted at
  (L + 1)/2 keys a query and the held experts at the assignments they
  get on average, k·n_held/E a token (the reference computes every held
  expert for every token, which is not the model's work).
- :func:`experts_call_work`: the least bytes and operations of one call of
  a MoE layer's expert part (the span ``prior.moe.experts``: the held
  experts over their assignments and the shared expert over every token):
  the tokens read and the output written once in bf16, each expert's f32
  weights read once; three matmuls a SwiGLU.
"""

from __future__ import annotations

from bench_cuda import peaks
from bench_cuda.reference.moonlight_prior import shape


def forward_flops_per_token(cfg: dict, *, keys: float, held_per_token: float) -> float:
    """One token's forward FLOPs, attention over ``keys`` keys, the held
    experts at ``held_per_token`` assignments a token."""
    s = shape(cfg)
    d, h, qk, dv = s["d"], s["heads"], s["nope"] + s["rope"], s["dv"]
    attn = 2 * (d * h * qk + d * (s["lora"] + s["rope"]) + s["lora"] * h * (s["nope"] + dv) + h * dv * d)
    attn += 2 * h * (qk + dv) * keys
    dense = 2 * 3 * d * s["dense"]
    moe = 2 * d * s["experts"] + 2 * 3 * d * s["expert"] * (s["shared"] + held_per_token)
    n_dense = min(s["first_dense"], s["layers"])
    return s["layers"] * attn + n_dense * dense + (s["layers"] - n_dense) * moe + 2 * d * s["codes"]


def step_flops(cfg: dict, batch: int) -> float:
    """Model FLOPs of one training step over ``batch`` grids, forward and backward."""
    s = shape(cfg)
    length = s["grid"] ** 2
    held = s["top_k"] * (s["hi"] - s["lo"]) / s["experts"]
    return 3.0 * batch * length * forward_flops_per_token(cfg, keys=(length + 1) / 2, held_per_token=held)


def experts_call_work(cfg: dict, held_assignments: float, tokens: int) -> tuple:
    """(bytes, operations) of one forward call of a MoE layer's experts."""
    s = shape(cfg)
    d, w = s["d"], s["expert"]
    per_expert = 3 * d * w  # a SwiGLU's weights (multiply-adds a row)
    ops = 2 * per_expert * (held_assignments + s["shared"] * tokens)
    nbytes = 2 * 2 * tokens * d + 4 * per_expert * ((s["hi"] - s["lo"]) + s["shared"])
    return nbytes, ops


def experts_call_least_seconds(cfg: dict, held_assignments: float, tokens: int) -> float:
    """The least time of a call: bytes at the HBM rate or bf16 operations at
    the dense peak, whichever is longer."""
    nbytes, ops = experts_call_work(cfg, held_assignments, tokens)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.PEAK_FLOPS["bfloat16"])
