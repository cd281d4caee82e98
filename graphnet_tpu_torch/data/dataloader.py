"""Events to bucketed, padded batches (counterpart of
``graphnet_tpu/data/dataloader.py``).

Padding runs in C++ on the host (``graphnet_tpu_torch/native.py``:
``native_pad_events``), or in numpy (``batch.pad_events``) where the
library cannot be built; batches come back as CPU tensors and the
caller (the Trainer, ``DeploymentModule``) moves them to its device.
Labels take the JAX package's dtypes after its packed transport: float
labels float32, integer labels int32, booleans bool.  ``stack_k > 1``
stacks k batches of one signature on the host
(:class:`~graphnet_tpu_torch.batch.StackedBatches`), for
``Trainer(steps_per_dispatch=k)``.  Not ported: the packed-label
transport itself (``HostPackedBatch``), which exists for the TPU
runtime's cost per transferred array.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from graphnet_tpu_torch.batch import (
    DEFAULT_BUCKETS,
    EventBatch,
    bucket_for_length,
    pad_events,
    stack_batches,
)
from graphnet_tpu_torch.models.graphs.graph_definition import Event
from graphnet_tpu_torch.native import native_pad_events, native_pad_node_labels
from graphnet_tpu_torch.utils.tracing import span


def _pad(xs: List[np.ndarray], L: int):
    """The native padding, or numpy's where the library is unavailable."""
    native = native_pad_events(xs, L)
    return native if native is not None else pad_events(xs, length=L)


def _label_tensor(v: np.ndarray) -> torch.Tensor:
    """A label as the JAX package's packed transport returns it."""
    if v.dtype.kind == "f":
        return torch.from_numpy(np.ascontiguousarray(v, np.float32))
    if v.dtype.kind == "b":
        return torch.from_numpy(np.ascontiguousarray(v))
    return torch.from_numpy(np.ascontiguousarray(v, np.int32))


def collate_events(
    events: List[Event],
    length: Optional[int] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    min_pulses: int = 2,
) -> Optional[EventBatch]:
    """Pad a list of Events into one EventBatch on the CPU.

    Events with fewer than ``min_pulses`` pulses are dropped.  Returns
    None if all events are dropped.
    """
    events = [e for e in events if e.n_pulses >= min_pulses]
    if not events:
        return None
    max_n = max(e.n_pulses for e in events)
    L = length if length is not None else bucket_for_length(max_n, buckets)
    x, mask, n_pulses = _pad([e.x for e in events], L)
    B = len(events)

    # labels common to every event, numeric only
    keys = set(events[0].labels)
    for e in events[1:]:
        keys &= set(e.labels)
    labels: Dict[str, torch.Tensor] = {}
    for k in sorted(keys):
        vals = [np.asarray(e.labels[k]) for e in events]
        if vals[0].dtype.kind not in "bifu":
            continue
        labels[k] = _label_tensor(np.stack(vals))  # [B] or [B, d]

    node_labels: Dict[str, torch.Tensor] = {}
    nl_keys = set(events[0].node_labels)
    for e in events[1:]:
        nl_keys &= set(e.node_labels)
    for k in sorted(nl_keys):
        vals = [np.asarray(e.node_labels[k]).reshape(-1) for e in events]
        arr = native_pad_node_labels(vals, L)
        if arr is None:
            arr = np.zeros((B, L), dtype=np.float32)
            for i, v in enumerate(vals):
                n = min(len(v), L)
                arr[i, :n] = v[:n]
        node_labels[k] = torch.from_numpy(arr)

    return EventBatch(
        x=torch.from_numpy(x),
        mask=torch.from_numpy(mask),
        n_pulses=torch.from_numpy(n_pulses),
        labels=labels,
        node_labels=node_labels,
    )


def collate_from_arrays(
    xs: List[np.ndarray],
    truth_names: Sequence[str],
    truth_mat: np.ndarray,
    dataset,
    length: Optional[int] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    min_pulses: int = 2,
) -> Optional[Tuple[EventBatch, int, int]]:
    """Node arrays and a ``[B, n_truth]`` truth matrix straight to a
    padded EventBatch, with column operations instead of per-event
    dicts: the same batch as fetching Events and calling
    :func:`collate_events`.

    Returns ``(batch, valid_slots, total_slots)``, or None if every
    event was dropped by ``min_pulses``.
    """
    keep = [i for i, x in enumerate(xs) if x.shape[0] >= min_pulses]
    if not keep:
        return None
    if len(keep) != len(xs):
        xs = [xs[i] for i in keep]
        truth_mat = truth_mat[np.asarray(keep)]
    B = len(xs)
    counts = np.array([x.shape[0] for x in xs], np.int32)
    L = (
        length
        if length is not None
        else bucket_for_length(int(counts.max()), buckets)
    )
    x, mask, n_pulses = _pad(xs, L)

    truth_cols = {k: truth_mat[:, i] for i, k in enumerate(truth_names)}
    # the per-event route's merge order: derived pid labels first, truth
    # columns overwrite, custom labels last
    labels = dataset._get_labels_batched(truth_cols, B)
    labels.update(truth_cols)
    labels["n_pulses"] = counts
    for key, fn in getattr(dataset, "_label_fns", {}).items():
        labels[key] = np.asarray(fn.batched(labels))

    batch = EventBatch(
        x=torch.from_numpy(x),
        mask=torch.from_numpy(mask),
        n_pulses=torch.from_numpy(n_pulses),
        labels={k: _label_tensor(np.asarray(v)) for k, v in labels.items()},
    )
    valid = int(np.minimum(counts, L).sum())
    return batch, valid, B * L


class LenMatchBatchSampler:
    """Group indices into batches of near-uniform event length: events
    are binned by ``n_pulses // bucket_width`` and a batch is emitted
    whenever a bin reaches ``batch_size``; the leftovers follow."""

    def __init__(
        self,
        lengths: Sequence[int],
        batch_size: int,
        bucket_width: int = 16,
        shuffle: bool = True,
        seed: Optional[int] = None,
        drop_last: bool = False,
    ):
        self._lengths = np.asarray(lengths)
        self._batch_size = batch_size
        self._bucket_width = bucket_width
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        order = np.arange(len(self._lengths))
        if self._shuffle:
            order = self._rng.permutation(order)
        bins: Dict[int, List[int]] = {}
        for idx in order:
            b = int(self._lengths[idx]) // self._bucket_width
            bins.setdefault(b, []).append(int(idx))
            if len(bins[b]) == self._batch_size:
                yield bins.pop(b)
        leftovers = [i for bucket in bins.values() for i in bucket]
        for start in range(0, len(leftovers), self._batch_size):
            chunk = leftovers[start : start + self._batch_size]
            if self._drop_last and len(chunk) < self._batch_size:
                continue
            yield chunk

    def __len__(self) -> int:
        n = len(self._lengths)
        return (
            n // self._batch_size
            if self._drop_last
            else math.ceil(n / self._batch_size)
        )


class DataLoader:
    """Iterate a Dataset as padded EventBatches (CPU tensors).

    Arguments and defaults are the JAX package's.  ``buckets="auto:N"``
    (the default, N=2) picks the N buckets that pad this dataset's
    length distribution least (``data/bucketing.py``); a sequence of
    lengths fixes them.  Each batch goes the vectorised route
    (:func:`collate_from_arrays`: two SQL queries, one detector pass,
    column labels) where the dataset, its graph definition and its
    custom labels allow it, else the Event route.  ``num_workers > 0``
    runs whole batches on a pool of threads, in order (each thread opens
    its own SQLite connections).  ``stack_k > 1`` groups k batches of one
    signature (shapes, label keys and dtypes) and yields them stacked on
    the host as a :class:`~graphnet_tpu_torch.batch.StackedBatches`; at
    the end of an epoch the batches left in each group follow singly, in
    the JAX package's order.  ``len()`` counts batches either way.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 128,
        shuffle: bool = False,
        seed: Optional[int] = None,
        buckets: Union[Sequence[int], str] = "auto:2",
        min_pulses: int = 2,
        length_matching: bool = True,
        bucket_width: int = 16,
        drop_last: bool = False,
        num_workers: int = 0,
        stack_k: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._auto_buckets: Optional[int] = None
        if isinstance(buckets, str):
            if buckets != "auto" and not buckets.startswith("auto:"):
                raise ValueError(
                    f"buckets={buckets!r}; expected 'auto', 'auto:N', "
                    "or a sequence of lengths"
                )
            self._auto_buckets = (
                int(buckets.split(":", 1)[1]) if ":" in buckets else 4
            )
            self._buckets: Tuple[int, ...] = ()
        else:
            self._buckets = tuple(buckets)
        self.min_pulses = min_pulses
        self.length_matching = length_matching
        self.bucket_width = bucket_width
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.stack_k = int(stack_k)
        self._pool = None
        self._fast_ok: Optional[bool] = None
        self._lengths: Optional[np.ndarray] = None
        # padding efficiency (valid pulses / padded slots) of the latest
        # epoch
        self._valid_slots = 0
        self._total_slots = 0

    def _event_lengths(self) -> np.ndarray:
        if self._lengths is None:
            if hasattr(self.dataset, "event_lengths"):
                self._lengths = np.asarray(self.dataset.event_lengths())
            else:
                self._lengths = np.asarray(
                    [self.dataset[i].n_pulses for i in range(len(self.dataset))]
                )
        return self._lengths

    def _batches(self) -> Iterator[List[int]]:
        if self.length_matching:
            yield from LenMatchBatchSampler(
                self._event_lengths(),
                self.batch_size,
                bucket_width=self.bucket_width,
                shuffle=self.shuffle,
                seed=self.seed,
                drop_last=self.drop_last,
            )
        else:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                order = np.random.default_rng(self.seed).permutation(order)
            for s in range(0, len(order), self.batch_size):
                chunk = order[s : s + self.batch_size].tolist()
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                yield chunk

    def _fetch(self, idxs: List[int]) -> List[Event]:
        get_events = getattr(self.dataset, "get_events", None)
        if get_events is not None:
            return get_events(idxs)
        return [self.dataset[i] for i in idxs]

    def _try_fast(self, idxs: List[int]):
        """The vectorised route: ``(batch_or_None, valid, total)``, or
        None to take the Event route (a dataset, graph definition or
        custom label that the route does not carry, or a NULL or TEXT
        cell in this batch)."""
        if self._fast_ok is False:
            return None
        ds = self.dataset
        gba = getattr(ds, "get_batch_arrays", None)
        gd = getattr(ds, "_graph_definition", None)
        if (
            gba is None
            or gd is None
            or not getattr(gd, "supports_batched", False)
            or any(
                not hasattr(fn, "batched")
                for fn in getattr(ds, "_label_fns", {}).values()
            )
        ):
            self._fast_ok = False
            return None
        self._fast_ok = True
        with span("graphnet.loader.fetch"):
            out = gba(idxs)
        if out is None:
            return None
        features_list, truth_mat = out
        with span("graphnet.loader.collate"):
            xs = gd.build_x_batched(features_list)
            if xs is None:
                return None
            res = collate_from_arrays(
                xs, ds._truth, truth_mat, ds, buckets=self.buckets,
                min_pulses=self.min_pulses,
            )
        return (None, 0, 0) if res is None else res

    @property
    def buckets(self) -> Tuple[int, ...]:
        """The bucket set; ``"auto[:N]"`` resolves at first access (one
        scan of the event lengths, which the sampler needs anyway)."""
        if self._auto_buckets is not None and not self._buckets:
            from graphnet_tpu_torch.data.bucketing import optimize_buckets

            self._buckets = optimize_buckets(
                self._event_lengths(), n_buckets=self._auto_buckets, align=16
            )
        return self._buckets

    def _one_batch(
        self, idxs: List[int]
    ) -> Optional[Tuple[EventBatch, int, int]]:
        """Fetch, build and collate one batch: ``(batch, valid_slots,
        total_slots)``, or None when every event was dropped."""
        with span("graphnet.loader.batch"):
            fast = self._try_fast(idxs)
            if fast is not None:
                batch, valid, total = fast
                return None if batch is None else (batch, valid, total)
            with span("graphnet.loader.fetch"):
                events = self._fetch(idxs)
            with span("graphnet.loader.collate"):
                batch = collate_events(
                    events, buckets=self.buckets, min_pulses=self.min_pulses
                )
            if batch is None:
                return None
            L = batch.max_length
            valid = sum(
                min(e.n_pulses, L)
                for e in events
                if e.n_pulses >= self.min_pulses
            )
            return batch, valid, batch.batch_size * L

    def _results(self) -> Iterator[Optional[Tuple[EventBatch, int, int]]]:
        if self.num_workers <= 0:
            for idxs in self._batches():
                yield self._one_batch(idxs)
            return
        # whole batches on the pool, a bounded window in flight, yielded
        # in order
        from collections import deque

        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="graphnet-loader",
            )
        inflight: deque = deque()
        for idxs in self._batches():
            inflight.append(self._pool.submit(self._one_batch, idxs))
            if len(inflight) > self.num_workers:
                yield inflight.popleft().result()
        while inflight:
            yield inflight.popleft().result()

    def _plain(self) -> Iterator[EventBatch]:
        for res in self._results():
            if res is None:
                continue
            batch, valid, total = res
            self._valid_slots += valid
            self._total_slots += total
            yield batch

    def __iter__(self) -> Iterator[EventBatch]:
        self.buckets  # resolve "auto"
        self._valid_slots = 0
        self._total_slots = 0
        if self.stack_k > 1:
            yield from self._iter_stacked(self._plain())
        else:
            yield from self._plain()

    def _iter_stacked(self, src: Iterator[EventBatch]) -> Iterator:
        """Groups of ``stack_k`` batches of one signature, stacked; the
        groups' leftovers singly at the end, group by group in the order
        each group was (re)opened."""
        k = self.stack_k
        buf: Dict[tuple, List[EventBatch]] = {}
        for batch in src:
            key = batch.signature()
            group = buf.setdefault(key, [])
            group.append(batch)
            if len(group) < k:
                continue
            del buf[key]
            yield stack_batches(group)
        for group in buf.values():
            yield from group

    @property
    def padding_efficiency(self) -> float:
        """Share of the padded node slots that hold real pulses in the
        latest (or ongoing) epoch; 1.0 is no waste."""
        if self._total_slots == 0:
            return float("nan")
        return self._valid_slots / self._total_slots

    def __len__(self) -> int:
        n = len(self.dataset)
        return (
            n // self.batch_size
            if self.drop_last
            else math.ceil(n / self.batch_size)
        )
