"""Share of the profiled training stretch in which no operation ran on the
card: 1 − (union of kernel, copy and fill intervals) / the stretch, in %."""


def read(traced: dict):
    tl = traced.get("timeline")
    if tl is None or tl.window_s <= 0:
        return None
    return (1.0 - tl.busy_s() / tl.window_s) * 100.0
