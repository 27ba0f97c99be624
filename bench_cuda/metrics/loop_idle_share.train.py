"""The device idle that the epoch loop causes: the device's idle time in the
labelled stretch that lies outside every ``train.step`` host range (the
port's span of one step), over the stretch, in %. That is the idle of
fetching batches, reading values to the host, logging and epoch ends; the
idle inside a step is its own launch-bound rest. Ranges and device
operations share the profiler's clock. None without a labelled stretch or
without ``train.step`` ranges in it."""

from bench_cuda.trace import idle_gaps, union_seconds


def read(traced: dict):
    tl = traced.get("labelled")
    if tl is None or tl.window_s <= 0:
        return None
    steps = [(s, e) for name, s, e in tl.host if name == "train.step"]
    if not steps:
        return None
    gaps = idle_gaps([(s, e) for _, s, e in tl.device_ops], *tl.window)
    outside = sum((e - s) - union_seconds(steps, s, e) for s, e in gaps)
    return outside / tl.window_s * 100.0
