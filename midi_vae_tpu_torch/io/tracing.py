"""Spans and counters inside the training step, on the profiler's clock.

A span is on exactly while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``): the train CLI's
``--profile-dir`` epochs, or any caller's own profiled stretch. There is
no flag of its own. Off, :func:`span` costs that one check and returns a
shared null context: no autograd node, no allocation.

On, a span is a ``torch.profiler.record_function(name)`` range, so it
lands in the same trace as the kernels, as a ``user_annotation`` on the
thread that opened it, nested under whatever range was open there. A span
records nothing on the device: it adds no kernel, event or
synchronisation to the step.

Spans and counters of the port (PERF.md §3 says which metric reads each):

- ``train.step``: ``train/state.py`` ``step``, the whole body;
- ``model.norm``: ``models/vae.py`` ``apply_norm``, every norm kind, the
  forward only (a range around the backward needs gradient hooks, whose
  host time, 1-3 ms a step of the folded model on an H100 host, shows in
  the device's idle share); for a BatchNorm that runs fused with its
  LeakyReLU (``norm_leaky_relu``), the fused operation's forward;
- counters ``norm.batch_calls`` and ``norm.fused_calls``:
  ``models/vae.py`` ``norm_leaky_relu`` adds one to the first for each
  ``BatchNorm`` forward of a conv block, and one to the second for each
  of those that took the fused operation's kernels (``ops/fused_norm.py``;
  on a card only); in a graphed step they count at the capture, not at
  the replays;
- ``train.dataloader``, ``train.device_step``, ``train.logging``: the
  epoch loop's phases (``PhaseTimer`` in ``io/logging.py``);
- counters ``train.steps`` and ``train.host_syncs``: folded in once an
  epoch from ``train_one_epoch``'s own counts;
- counter ``train.graph_steps``: ``train/state.py`` ``step`` adds one for
  each step whose encoder and decoder ran as CUDA graph replays
  (``train/graphs.py``); the ``model.norm`` ranges of those steps open
  only while the graphs are captured, at the first step of a batch shape;
- ``model.quantize`` and ``model.codebook_update``: ``models/vq.py``
  ``VectorQuantizerEMA.forward``, the nearest-code search with the code
  gather and the straight-through value, then (in training) the sums'
  reduction and the EMA update, one range each a call, side by side;
- counters ``vq.calls`` and ``vq.vectors``: every quantizer call adds one
  and its number of vectors (a host integer from the shape);
- counter ``vq.fused_calls``: the same call adds one when it took the
  search and sum kernels (counted in ``ops/vq_search.py``
  ``nearest_codes``, where they are taken; on a card only);
- ``prior.step``: ``cli/train_prior.py`` ``make_prior_step``'s step, the
  whole body; counter ``prior.steps``: one a step;
- ``prior.attention``: ``models/moe_prior.py`` ``MLA.forward``, each
  latent attention's forward;
- ``prior.moe.route`` and ``prior.moe.experts``: ``models/moe_prior.py``
  ``MoE.forward``, side by side: the router, its top-k, weights, loads
  and balance term; then the dispatch, the held experts, the combine and
  the shared expert (the forward only: the held experts' recompute in the
  backward lies outside);
- counters ``moe.calls`` and ``moe.assignments``: each MoE layer's
  forward adds one and its tokens × experts a token (host integers from
  the shapes);
- counters ``moe.held_assignments`` and ``moe.held_max``: the
  assignments to the experts a layer holds, and the largest held
  expert's, summed over the layers and steps; ``train_prior_epoch``
  folds them in from the steps' outputs at its one host read a chunk.

Counters always count.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

_NULL = contextlib.nullcontext()
_counters: Dict[str, int] = {}
_lock = threading.Lock()


def enabled() -> bool:
    """True while a profiler records, the only time spans are on."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """The range ``name`` while a profiler records, else a shared null context."""
    return torch.profiler.record_function(name) if enabled() else _NULL


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``; nothing while ``torch.compile`` or
    ``torch.export`` traces the caller (the trace runs once for many calls,
    and a shape it passes may be symbolic)."""
    if torch.compiler.is_compiling():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Forget the counters."""
    with _lock:
        _counters.clear()
