"""Micro-batching request queue (counterpart of
``midi_vae_tpu/serving/batcher.py``, the same semantics).

Callers submit variable-size requests; a background thread coalesces them
into one padded batch per tick (bounded by ``max_batch`` and
``max_wait_ms``), runs the batched model function once per bucket-sized
chunk and slices each caller's rows back out. Throughput comes from
batching; latency is bounded by the wait window.

Buckets keep the batch shapes few: on the card each new shape meets cuDNN
and the allocator for the first time, as each new shape compiles in the
JAX package. ``fn`` runs on the dispatcher thread; ``torch.inference_mode``
is per thread, so an ``fn`` that needs it enters it itself. Labelled
requests (conditional models) are not ported yet (ROADMAP item 17).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np

_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // _BUCKETS[-1]) * _BUCKETS[-1]


class MicroBatcher:
    """Coalesce per-request arrays into padded batches.

    ``fn`` is the batched model function: called with a [B, ...] numpy
    array, B always one of the bucket sizes and at most ``max_batch``; it
    returns [B, ...] results. ``max_batch`` (clamped to a bucket size)
    bounds a coalesced batch; ``max_wait_ms`` is how long the dispatcher
    waits to fill one. ``item_shape`` fixes the per-item trailing shape up
    front (else the first request sets it); a request of another shape is
    refused at its own ``submit``.
    """

    def __init__(
        self,
        fn: Callable,
        *,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        item_shape: "tuple | None" = None,
    ):
        self.fn = fn
        # clamp the cap to a bucket size so padding never exceeds it
        self.max_batch = _bucket(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self._item_shape = tuple(item_shape) if item_shape is not None else None
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()  # serialises submit against close's drain
        self._carry = None  # item taken from the queue but deferred to the next tick
        self.batches_dispatched = 0
        self.requests_served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, x: np.ndarray) -> Future:
        """Enqueue a [n, ...] request; the future resolves to its [n, ...]
        result. Raises ``ValueError`` at once (in the caller's thread) when
        the request's item shape breaks the batcher's contract; other
        requests in flight are unaffected."""
        x = np.asarray(x)
        if x.ndim < 1 or len(x) == 0:
            raise ValueError(f"request must be a non-empty [n, ...] array, got shape {x.shape}")
        fut: Future = Future()
        with self._submit_lock:
            # checked under the lock: close() drains under the same lock, so a
            # put can never land after the drain and hang its caller
            if self._stop.is_set():
                raise RuntimeError("batcher is closed")
            if self._item_shape is None:
                self._item_shape = tuple(x.shape[1:])  # the first request sets the contract
            elif tuple(x.shape[1:]) != self._item_shape:
                raise ValueError(
                    f"request item shape {tuple(x.shape[1:])} does not match the "
                    f"batcher's item shape {self._item_shape}"
                )
            self._queue.put((x, fut))
        return fut

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return self.submit(x).result()

    def _loop(self):
        while not self._stop.is_set():
            if self._carry is not None:
                first, self._carry = self._carry, None
            else:
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
            pending = [first]
            total = len(first[0])
            deadline = time.monotonic() + self.max_wait
            while total < self.max_batch and time.monotonic() < deadline:
                try:
                    item = self._queue.get(timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if total + len(item[0]) > self.max_batch:
                    self._carry = item  # respect the cap; serve it next tick
                    break
                pending.append(item)
                total += len(item[0])
            self._dispatch(pending)
        # shutdown: a carry deferred mid-tick must not strand its waiter, since
        # close() may have drained before this tick parked it; under the submit
        # lock so close()'s own carry handling cannot resolve it twice
        with self._submit_lock:
            if self._carry is not None:
                self._carry[1].set_exception(RuntimeError("batcher closed"))
                self._carry = None

    def _dispatch(self, pending: Sequence):
        try:
            batch = np.concatenate([x for x, _ in pending])
            # a single submit may exceed max_batch (coalescing caps only
            # multi-request ticks): run it in max_batch-sized chunks, so fn
            # only ever sees bucket sizes <= max_batch
            outs = []
            n_chunks = 0
            for start in range(0, len(batch), self.max_batch):
                rows = batch[start : start + self.max_batch]
                n = len(rows)
                size = _bucket(n)
                if size > n:  # pad to the bucket
                    rows = np.concatenate([rows, np.zeros((size - n, *rows.shape[1:]), rows.dtype)])
                outs.append(np.asarray(self.fn(rows))[:n])
                n_chunks += 1
            out = outs[0] if len(outs) == 1 else np.concatenate(outs)
        except Exception as e:  # noqa: BLE001 - to every waiter; the dispatcher thread survives
            for _, fut in pending:
                fut.set_exception(e)
            return
        # counters first: a caller woken by result() must see them updated;
        # one count per device batch (an oversized submit dispatches several)
        self.batches_dispatched += n_chunks
        self.requests_served += len(pending)
        offset = 0
        for x, fut in pending:
            fut.set_result(out[offset : offset + len(x)])
            offset += len(x)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        with self._submit_lock:  # no submit can interleave with the drain
            if self._carry is not None:
                self._carry[1].set_exception(RuntimeError("batcher closed"))
                self._carry = None
            while True:
                try:
                    _, fut = self._queue.get_nowait()
                    fut.set_exception(RuntimeError("batcher closed"))
                except queue.Empty:
                    break
