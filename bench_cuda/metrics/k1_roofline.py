"""K1's share of its roofline: the least time one call could take (its
logits and targets read once, its result written once, at 3.35 TB/s; or
its operations at the f32 peak, whichever is longer) over the device time
of a call (``_bce_partial_kernel`` and ``_sum_partials_kernel`` together),
in %, over the calls in the profiled stretch."""

from bench_cuda.roofline import kernel_roofline


def read(traced: dict):
    return kernel_roofline(traced, "K1", ("_bce_partial_kernel", "_sum_partials_kernel"), "_bce_partial_kernel")
