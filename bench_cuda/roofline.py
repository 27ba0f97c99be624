"""A kernel's share of its roofline from the profiled stretch."""

from __future__ import annotations

from bench_cuda import counts


def kernel_roofline(traced: dict, key: str, fragments, one_per_call: str):
    """100 × (least time of a call, from the recorded call shapes) / (the
    device time of the kernels named by ``fragments`` per call, a call
    counted by the kernel named ``one_per_call``); None when the stretch
    holds no call."""
    tl, calls = traced.get("timeline"), traced.get("kernel_calls", {}).get(key)
    if tl is None or not calls:
        return None
    lo, hi = tl.window
    mine = [(name, s, e) for name, s, e in tl.kernels if any(f in name for f in fragments) and lo <= s and e <= hi]
    n_calls = sum(1 for name, _, _ in mine if one_per_call in name)
    if n_calls == 0:
        return None
    device_s = sum(e - s for _, s, e in mine) / n_calls
    bounds = [counts.bound_seconds(*counts.kernel_cost(key, *call)) for call in calls]
    return sum(bounds) / len(bounds) / device_s * 100.0
