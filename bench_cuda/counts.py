"""Operations and bytes: the model's FLOPs per step, counted on the
benchmark's own reference, and what the port's kernels K1 and K2 must
read, write and compute for one call."""

from __future__ import annotations

import torch

from bench_cuda import peaks

# operations per element, counted from the kernels' bodies (exp, log as one each)
OPS_PER_ELEMENT = {"K1": 23, "K2": 23}


def model_flops(ref_module, cfg: dict, batch: int) -> int:
    """Matmul and convolution FLOPs (2 per multiply-add) of one training
    step's forward and backward at ``batch``, as the reference computes
    them, counted by ``torch.utils.flop_counter`` on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    model = ref_module.Model(cfg)
    params, _ = ref_module.spec(cfg)
    P = {name: torch.empty(shape, device="meta", requires_grad=True) for name, shape, _ in params}
    size, c = int(cfg["image_size"]), int(cfg.get("in_channels", 1))
    x = torch.empty((batch, size, size, c), device="meta")
    eps = torch.empty((batch, int(cfg["n_features"])), device="meta")
    with FlopCounterMode(display=False) as counter:
        logits, mu, lv = model.forward_train(P, x, eps)
        loss, _, _ = ref_module.elbo(logits, x, mu, lv, 1.0)
        torch.autograd.grad(loss, list(P.values()))
    return int(counter.get_total_flops())


def kernel_cost(key: str, n_elements: int, logit_bytes: int, target_bytes: int) -> tuple:
    """(bytes, operations) of one call of K1 or K2 over ``n_elements``
    logits: each input byte read once, each output byte written once. K1
    reads logits and targets and writes one f32; K2 also reads the f32
    upstream gradient and writes a gradient in the logits' dtype."""
    if key == "K1":
        nbytes = n_elements * (logit_bytes + target_bytes) + 4
    elif key == "K2":
        nbytes = n_elements * (2 * logit_bytes + target_bytes) + 4
    else:
        raise ValueError(f"no count for kernel {key!r}")
    return nbytes, n_elements * OPS_PER_ELEMENT[key]


def bound_seconds(nbytes: int, ops: int, ops_dtype: str = "float32") -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at the dtype's peak, whichever is longer."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.PEAK_FLOPS[ops_dtype])
