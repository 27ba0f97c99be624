"""The weights a cell runs with, made by the benchmark from the seed.

One draw on the device from a ``torch.Generator`` seeded with the run's
seed, cut into the leaves of a reference's ``spec``: Xavier-uniform
kernels (the bound from the fans of torch's ``xavier_uniform_``), zero
biases, unit BatchNorm scales and the output bias from the configuration's
``output_bias_init``. Both the port and the reference get these same
tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch


def _fans(shape) -> tuple:
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def output_bias(cfg: dict, corpus: Optional[torch.Tensor]) -> float:
    """The output conv's bias: 0 unless ``output_bias_init`` says; "auto"
    is log(p / (1 − p)) of the corpus's mean pixel p in [0, 1], p clipped
    to [1e-4, 1 − 1e-4]."""
    init = cfg.get("output_bias_init")
    if init is None:
        return 0.0
    if init != "auto":
        return float(init)
    p = float(corpus.sum()) / (corpus.numel() * 255.0)
    p = float(np.clip(p, 1e-4, 1.0 - 1e-4))
    return math.log(p / (1.0 - p))


def make(spec, seed: int, device, *, logit_bias: float = 0.0) -> Dict[str, torch.Tensor]:
    """name → f32 tensor on ``device`` for every parameter of ``spec``
    (``(params, buffers)`` of a reference; the buffers keep the model's own
    initial values)."""
    params, _ = spec
    gen = torch.Generator(device=device).manual_seed(int(seed))
    drawn = [leaf for leaf in params if leaf[2] == "xavier"]
    u = torch.rand(sum(math.prod(s) for _, s, _ in drawn), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init in params:
        if init == "xavier":
            n = math.prod(shape)
            v = u[at : at + n].reshape(shape)
            at += n
            fan_in, fan_out = _fans(shape)
            out[name] = (v * 2.0 - 1.0) * math.sqrt(6.0 / (fan_in + fan_out))
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "logit_bias":
            out[name] = torch.full(shape, float(logit_bias), device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out
