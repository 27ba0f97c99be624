"""K2's share of its roofline: the least time one call could take (logits,
targets and the upstream gradient read once, the gradient written once, at
3.35 TB/s; or its operations at the f32 peak, whichever is longer) over
the device time of a call of ``_bce_grad_kernel``, in %."""

from bench_cuda.roofline import kernel_roofline


def read(traced: dict):
    return kernel_roofline(traced, "K2", ("_bce_grad_kernel",), "_bce_grad_kernel")
