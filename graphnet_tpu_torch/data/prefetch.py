"""Host-side prefetching: overlap the loader's host work with device
compute (counterpart of ``graphnet_tpu/data/prefetch.py``).

A producer thread runs the loader (SQL queries, graph building,
padding) and copies each batch to the device; the consumer takes the
batches from a bounded queue.

On a CUDA device the producer copies on a stream of its own: each
tensor is pinned and copied with ``non_blocking=True`` there, and an
event is recorded after the copies.  The consumer makes its current
stream wait on that event and marks every tensor with
``record_stream``, so the caching allocator does not hand the memory
back to the producer's stream while a step still reads it.  Copying on
the default stream instead would be correct too, but each copy would
then queue behind the steps already enqueued and overlap nothing.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from graphnet_tpu_torch.batch import EventBatch, StackedBatches
from graphnet_tpu_torch.device import DeviceLike, resolve_device


def _tensors(batch) -> EventBatch:
    return batch.batches if isinstance(batch, StackedBatches) else batch


def _map(batch, fn):
    """``fn`` applied to every tensor of an EventBatch or StackedBatches."""
    if isinstance(batch, StackedBatches):
        return StackedBatches(batches=batch.batches.map(fn), k=batch.k)
    return batch.map(fn)


def pinned(batch):
    """A copy of ``batch`` in pinned host memory (where a CUDA device is
    present; else plain host memory)."""
    pin = torch.cuda.is_available()
    return _map(batch, lambda t: t.cpu().pin_memory() if pin
                else t.cpu().clone())


class _Copier:
    """Copies batches to ``device`` from the producer thread."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stream = None

    def put(self, batch) -> Tuple[object, Optional[torch.cuda.Event]]:
        """``(batch on the device, event after its copies or None)``."""
        if self.device.type != "cuda":
            return _map(batch, lambda t: t.to(self.device)), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)

        def copy(t):
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            moved = _map(batch, copy)
            done = torch.cuda.Event()
            done.record(self._stream)
        return moved, done

    def take(self, item):
        """The consumer's side of :meth:`put`: its stream waits for the
        copies, and each tensor is marked as used on that stream."""
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in _tensors(batch).tensors().values():
                t.record_stream(stream)
        return batch


class PrefetchingLoader:
    """Wrap a re-iterable batch loader with a producer thread that runs
    it ``prefetch`` batches ahead and copies them to ``device``.

    Args:
        loader: the underlying loader (DataLoader, CachingLoader, ...).
        prefetch: batches staged ahead (2 is double buffering).
        device: where the batches go (the GPU unless ``"cpu"``).
    """

    def __init__(self, loader, prefetch: int = 2, device: DeviceLike = "cuda"):
        self.loader = loader
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device)

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        """Forward the epoch to the wrapped loader, where it takes one
        (``Trainer.fit`` sees this wrapper, not the loader inside)."""
        inner = getattr(self.loader, "set_epoch", None)
        if inner is not None:
            inner(epoch)

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []
        copier = _Copier(self.device)

        def worker() -> None:
            try:
                for batch in self.loader:
                    q.put(copier.put(batch))
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield copier.take(item)
        t.join()
        if err:
            raise err[0]


class EpochPipeline:
    """One producer thread for all epochs: it iterates the loader for
    each epoch in turn (calling its ``set_epoch`` first, where it has
    one) and copies the batches to the device; the consumer takes one
    epoch's batches at a time with :meth:`epoch`.

    Re-wrapping a :class:`PrefetchingLoader` every epoch drains the
    pipeline and starts it again at each boundary; one producer builds
    epoch e+1's first batches while the device finishes epoch e.  The
    epoch boundaries travel in the queue as markers, and an error of
    the producer is raised in the consumer.  :meth:`close` stops the
    producer (it checks a stop flag around every blocking put): call it
    when training ends early, or use the context manager.

    Args:
        loader: a re-iterable batch loader.
        n_epochs: stream the epochs ``start_epoch`` to ``n_epochs - 1``.
        prefetch: queue depth in items (a StackedBatches counts as one).
        device: where the batches go (the GPU unless ``"cpu"``).
        start_epoch: the first epoch (resume).
    """

    def __init__(self, loader, n_epochs: int, prefetch: int = 4,
                 device: DeviceLike = "cuda", start_epoch: int = 0):
        self.loader = loader
        self.n_epochs = int(n_epochs)
        self.prefetch = max(1, int(prefetch))
        self.device = resolve_device(device)
        self.start_epoch = int(start_epoch)
        self._copier = _Copier(self.device)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._started = False

    def _put(self, item) -> bool:
        """A blocking put that gives up once :meth:`close` is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for e in range(self.start_epoch, self.n_epochs):
                if self._stop.is_set():
                    return
                se = getattr(self.loader, "set_epoch", None)
                if se is not None:
                    se(e)
                for batch in self.loader:
                    if not self._put(("batch", self._copier.put(batch))):
                        return
                if not self._put(("end", e)):
                    return
        except BaseException as exc:  # raised again in the consumer
            self._put(("error", exc))

    def epoch(self) -> Iterator:
        """The next epoch's batches (consume the epochs in order; each
        call ends at the next epoch marker)."""
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            kind, payload = self._q.get()
            if kind == "batch":
                yield self._copier.take(payload)
            elif kind == "end":
                return
            else:
                raise payload

    def close(self) -> None:
        """Stop the producer (idempotent; safe mid-epoch: the thread
        ends at its next put or loop check)."""
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._started:
            self._thread.join(timeout=10)

    def __enter__(self) -> "EpochPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class CachingLoader:
    """Keep the wrapped loader's batches from its first epoch and replay
    them from memory after: the host pipeline (SQL, graph building,
    padding, the copy) runs once.

    Graph building is deterministic per event, so the replay is exact;
    only the batch order changes: the first epoch yields in the loader's
    order, and epoch e after it (with ``shuffle``) in the order
    ``np.random.default_rng(seed + e).permutation``.

    * ``store="device"``: the batches stay on ``device``; replay moves
      nothing.
    * ``store="host"``: pinned host copies, copied to ``device`` again on
      replay; bounded by host memory instead of device memory.
    """

    def __init__(self, loader, shuffle: bool = True, seed: int = 0,
                 store: str = "device", device: DeviceLike = "cuda"):
        if store not in ("device", "host"):
            raise ValueError(f"store must be 'device' or 'host'; got {store!r}")
        self.loader = loader
        self.shuffle = shuffle
        self.seed = seed
        self.store = store
        self.device = resolve_device(device)
        self._cache: Optional[list] = None
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the replay order to ``epoch`` (see
        ``MaterializedLoader.set_epoch``); ignored while the cache is
        cold: the first iteration yields in the loader's order."""
        self._epoch = int(epoch) if self._cache is not None else 0

    def __len__(self) -> int:
        if self._cache is not None:
            return len(self._cache)
        return len(self.loader)

    def __iter__(self) -> Iterator:
        if self._cache is None:
            cache = []
            for batch in self.loader:
                if self.store == "host":
                    cache.append(pinned(batch))
                else:
                    batch = _map(batch, lambda t: t.to(self.device))
                    cache.append(batch)
                yield batch
            self._cache = cache
            self._epoch = 1
            return
        order = range(len(self._cache))
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + self._epoch).permutation(len(self._cache))
        self._epoch += 1
        for i in order:
            b = self._cache[i]
            if self.store == "host":
                b = _map(b, lambda t: t.to(self.device, non_blocking=True))
            yield b
