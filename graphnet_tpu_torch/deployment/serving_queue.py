"""Micro-batching serving queue (counterpart of
``graphnet_tpu/deployment/serving_queue.py``).

A model served one event at a time pays its fixed per-call cost (host
work, launches, the host-device copies) for every event.  A queue that
coalesces concurrent requests into one padded batch pays it once per
batch: with W threads feeding events, an event waits about
``call / W + compute`` instead of ``call + compute``.

* ``submit`` enqueues an event and returns a ``Future``;
* one collector thread takes the first pending event, waits at most
  ``max_wait_ms`` for more (not at all once ``max_batch`` are pending),
  and runs ONE call of the module on the coalesced list.  The model runs
  in that thread: the kernel wrappers launch on the tensors' device and
  the thread's current stream;
* an exception of the module reaches every future of its batch;
* ``close`` lets the collector finish every event submitted before it.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from graphnet_tpu_torch.models.graphs.graph_definition import Event

_STOP = object()


class ServingQueue:
    """Coalesce concurrent single-event requests into batched calls."""

    def __init__(self, module, max_batch: int = 32, max_wait_ms: float = 2.0):
        """Args:
        module: a ``DeploymentModule``, or any callable mapping a list of
            events to ``[n, cols]`` rows (or, for node-level tasks, to a
            list of per-event arrays).
        max_batch: the largest coalesced batch.
        max_wait_ms: how long the collector waits for more events after
            the first pending one; 0 batches only what is already queued.
        """
        self.module = module
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._collector, name="serving-queue", daemon=True)
        self._thread.start()

    def submit(self, event: Event) -> Future:
        """Enqueue one event; the future resolves to its prediction row
        (``[cols]`` for graph-level tasks, ``[n_pulses, cols]`` for
        node-level ones)."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingQueue is closed")
            self._q.put((event, fut))
        return fut

    def predict(self, event: Event, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking :meth:`submit`."""
        return self.submit(event).result(timeout=timeout)

    def predict_many(self, events: List[Event],
                     timeout: Optional[float] = None) -> List[np.ndarray]:
        futs = [self.submit(e) for e in events]
        return [f.result(timeout=timeout) for f in futs]

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Serve every pending event, then stop the collector."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(_STOP)
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _collector(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            pending = [item]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            stop = False
            while len(pending) < self.max_batch:
                try:
                    nxt = self._q.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if nxt is _STOP:  # nothing is submitted after it
                    stop = True
                    break
                pending.append(nxt)
            self._run_batch(pending)
            if stop:
                return

    def _run_batch(self, pending) -> None:
        try:
            rows = self.module([e for e, _ in pending])
        except Exception as exc:  # every waiter of the batch sees it
            for _, fut in pending:
                fut.set_exception(exc)
            return
        per_event = list(rows)  # rows of an array, or per-event arrays
        for (_, fut), row in zip(pending, per_event):
            fut.set_result(row)


def serve_events_parallel(module, events: List[Event], n_workers: int = 8,
                          max_batch: int = 32,
                          max_wait_ms: float = 2.0) -> List[np.ndarray]:
    """Feed ``events`` through a :class:`ServingQueue` from ``n_workers``
    threads (as a detector's per-frame loop with worker parallelism
    would) and return the predictions in input order."""
    with ServingQueue(module, max_batch=max_batch,
                      max_wait_ms=max_wait_ms) as sq:
        with ThreadPoolExecutor(n_workers) as pool:
            futs = list(pool.map(sq.submit, events))
        return [f.result() for f in futs]
