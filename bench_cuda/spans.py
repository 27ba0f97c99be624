"""Device time by host range, from a labelled ``torch.profiler`` stretch.

:func:`profile` runs a callable in a labelled stretch (CPU and CUDA
activity, inside the :data:`bench_cuda.trace.STRETCH` annotation, as
``trace.profile`` takes one) and keeps, beside the stretch's
:class:`~bench_cuda.trace.Timeline`, for every name of a host range
(``user_annotation``: the port's spans, ``io/tracing.py``) the number of
such ranges and the device time launched inside them.

A device operation (kernel, copy or fill) is launched inside a range when
the host call that launched it (a ``cuda_runtime`` or ``cuda_driver``
event, matched to the operation by Kineto's ``correlation``) starts inside
the range, on any thread of the process: the autograd engine launches the
backward from a thread of its own, while the step's range is open on the
main thread. A launch inside nested ranges counts for each of their
names, and once for a name however many of its ranges hold it.
"""

from __future__ import annotations

import bisect
import importlib.util
import sys
from typing import Callable, Dict, List, Tuple

from bench_cuda import trace

_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merged(intervals: List[Tuple[float, float]]) -> Tuple[list, list]:
    """The union of ``intervals`` as sorted starts and ends."""
    starts, ends = [], []
    for s, e in sorted(intervals):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def attribute(events: list) -> Dict[str, Tuple[int, float]]:
    """name → (ranges of that name, seconds of device time launched inside
    them) for every host range in the Chrome trace's ``traceEvents``."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ranges: Dict[str, list] = {}
    for e in spans:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    launched = {e["args"]["correlation"]: e["ts"] for e in spans
                if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
    merged = {name: _merged(iv) for name, iv in ranges.items()}
    device_us = dict.fromkeys(ranges, 0.0)
    for e in spans:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        for name, (starts, ends) in merged.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ends[i]:
                device_us[name] += e["dur"]
    return {name: (len(ranges[name]), device_us[name] * 1e-6) for name in ranges}


class Labelled:
    """A labelled stretch: its :class:`~bench_cuda.trace.Timeline` and, by
    range name, (ranges, device seconds launched inside them)."""

    def __init__(self, events: list):
        self.timeline = trace.parse_chrome_trace(events)
        self.by_range = attribute(events)

    def ranges(self, name: str) -> int:
        return self.by_range.get(name, (0, 0.0))[0]

    def device_s(self, name: str) -> float:
        return self.by_range.get(name, (0, 0.0))[1]


def profile(fn: Callable[[], None]) -> Labelled:
    """Run ``fn`` in a labelled stretch on this thread: ``trace.profile``'s
    labelled branch, from a private copy of ``trace.py`` that hands the
    raw events to :class:`Labelled` in place of ``parse_chrome_trace``."""
    spec = importlib.util.spec_from_file_location("bench_cuda_trace_labelled", trace.__file__)
    module = sys.modules[spec.name] = importlib.util.module_from_spec(spec)  # its dataclass looks itself up
    spec.loader.exec_module(module)
    module.parse_chrome_trace = Labelled
    return module.profile(fn, device_only=False)
