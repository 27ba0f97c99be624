"""Kernels launched per training step: the kernels in the profiled stretch
over its steps."""


def read(traced: dict):
    tl, steps = traced.get("timeline"), traced.get("stretch_steps")
    if tl is None or not steps:
        return None
    return len(tl.kernels) / steps
