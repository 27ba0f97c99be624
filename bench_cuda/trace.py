"""The device timeline of a short stretch, from ``torch.profiler``.

:func:`profile` runs a callable under the profiler and reads the Chrome
trace back (through a temporary file it deletes). Two kinds of stretch:

- device-only (CUDA activity alone): the host runs as it does untraced, so
  the device's busy and idle time are an untraced run's. The stretch is
  the interval from the start of a marker kernel (``torch.cuda._sleep``'s
  ``spin_kernel``) launched after a synchronisation before the work to
  the end of one launched after a synchronisation after it;
- labelled (CPU and CUDA activity): the host's operations are recorded
  too, which slows the host, so it serves only to say what the host was
  doing in each idle gap. The stretch is an annotation's host interval,
  opened and closed after synchronisations.

:class:`Timeline` holds the device operations (kernels, copies, fills),
the host operations and the stretch; the helpers compute the union of
intervals, the idle gaps and the ``breakdown`` a result line carries.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

STRETCH = "bench_cuda.stretch"
MARK = "spin_kernel"
MARK_CYCLES = 1000
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")

Interval = Tuple[float, float]


@dataclass
class Timeline:
    """Times in seconds on the profiler's clock."""

    window: Interval
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)  # every thread of the process

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device_ops], *self.window)


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def idle_gaps(intervals, lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(s, e) for s, e in gaps if e > s]


def host_label(host: List[Tuple[str, float, float]], starts: List[float], t: float) -> str:
    """The innermost host operation running at ``t`` (the latest-started
    one that still runs), or ``(host between operations)``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, -1), -1):
        name, s, e = host[j]
        if e >= t and name != STRETCH:
            return name
    return "(host between operations)"


def breakdown(tl: Timeline, labelled: Optional[Timeline] = None, top: int = 10) -> dict:
    """``device_ops``: the device operations with the most time in the
    stretch ``tl``, summed by name; ``idle_gaps``: the device's idle time
    in ``labelled`` (a stretch with the host's operations; ``tl`` without
    one) summed by what the host was doing at each gap's middle."""
    labelled = labelled or tl
    by_op: dict = {}
    for name, s, e in tl.device_ops:
        by_op[name] = by_op.get(name, 0.0) + (min(e, tl.window[1]) - max(s, tl.window[0]))
    starts = [s for _, s, _ in labelled.host]
    by_host: dict = {}
    for s, e in idle_gaps([(s, e) for _, s, e in labelled.device_ops], *labelled.window):
        label = host_label(labelled.host, starts, (s + e) / 2)
        by_host[label] = by_host.get(label, 0.0) + (e - s)

    def first(d):
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top] if v > 0]

    return {"device_ops": first(by_op), "idle_gaps": first(by_host)}


def parse_chrome_trace(events: list) -> Timeline:
    """A :class:`Timeline` from the Chrome trace's ``traceEvents``: the
    stretch from the :data:`STRETCH` annotation if the trace has one, else
    from the first and last :data:`MARK` kernels (left out of the device
    operations)."""
    us = 1e-6
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    stretch = [e for e in spans if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
    marks = sorted((e for e in spans if e.get("cat") == "kernel" and MARK in e.get("name", "")), key=lambda e: e["ts"])
    if stretch:
        st = stretch[0]
        window, pid = (st["ts"] * us, (st["ts"] + st["dur"]) * us), st.get("pid")
    elif len(marks) >= 2:
        window, pid = (marks[0]["ts"] * us, (marks[-1]["ts"] + marks[-1]["dur"]) * us), None
    else:
        raise RuntimeError("the profile holds neither a stretch annotation nor two marker kernels")
    tl = Timeline(window=window)
    for e in spans:
        cat, s = e.get("cat", ""), e["ts"] * us
        item = (e.get("name", ""), s, s + e["dur"] * us)
        if cat in _DEVICE_CATS and not (cat == "kernel" and MARK in item[0]):
            tl.device_ops.append(item)
            if cat == "kernel":
                tl.kernels.append(item)
        elif cat in _HOST_CATS and pid is not None and e.get("pid") == pid:
            tl.host.append(item)
    tl.device_ops.sort(key=lambda it: it[1])
    tl.kernels.sort(key=lambda it: it[1])
    tl.host.sort(key=lambda it: it[1])
    return tl


def profile(fn: Callable[[], None], device_only: bool) -> Timeline:
    """Run ``fn`` in a profiled stretch on this thread and return its
    :class:`Timeline`: device-only (needs a CUDA card) or labelled."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if device_only:
        prof = torch_profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        try:
            sync()
            torch.cuda._sleep(MARK_CYCLES)
            fn()
            sync()
            torch.cuda._sleep(MARK_CYCLES)
            sync()
        finally:
            prof.stop()
    else:
        prof = torch_profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
        prof.start()
        try:
            with record_function(STRETCH):
                sync()
                fn()
                sync()
        finally:
            prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_cuda_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse_chrome_trace(events)
