"""Dense-padded event batches (counterpart of ``graphnet_tpu/batch.py``).

The layout is the JAX package's: ``x [B, L, D]`` float32 node features,
zero-padded, and ``mask [B, L]`` bool validity.  Events are padded to
length *buckets* so only a few shapes occur.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from graphnet_tpu_torch.device import DeviceLike


@dataclass
class EventBatch:
    """A batch of padded events.

    Attributes:
        x: ``[B, L, D]`` float32 node (pulse) features, zero-padded.
        mask: ``[B, L]`` bool; True where the node is a real pulse.
        n_pulses: ``[B]`` int32 number of valid pulses per event.
        labels: per-event truth tensors, each ``[B]`` or ``[B, d]``.
        node_labels: per-node truth tensors, each ``[B, L]``.
        edges: optional precomputed neighbour indices ``[B, L, k]`` int32.
        edge_mask: optional ``[B, L, k]`` bool mask for ``edges``.
        event_weight: optional ``[B]`` float loss weight per event (real
            events ``B_padded / B_real``, padding events 0, so a padded
            batch's mean loss equals the unpadded one's).

    The JAX package's packed-label transport (``packed_f``, ``unpack``)
    is not ported: it exists for the TPU runtime's per-argument dispatch
    cost.
    """

    x: torch.Tensor
    mask: torch.Tensor
    n_pulses: torch.Tensor
    labels: Dict[str, torch.Tensor] = field(default_factory=dict)
    node_labels: Dict[str, torch.Tensor] = field(default_factory=dict)
    edges: Optional[torch.Tensor] = None
    edge_mask: Optional[torch.Tensor] = None
    event_weight: Optional[torch.Tensor] = None

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "EventBatch":
        """Copy of the batch with ``fn`` applied to every tensor."""

        def f(t):
            return None if t is None else fn(t)

        return replace(
            self,
            x=f(self.x),
            mask=f(self.mask),
            n_pulses=f(self.n_pulses),
            labels={k: f(v) for k, v in self.labels.items()},
            node_labels={k: f(v) for k, v in self.node_labels.items()},
            edges=f(self.edges),
            edge_mask=f(self.edge_mask),
            event_weight=f(self.event_weight),
        )

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the batch by a stable name (``x``, ``mask``,
        ``n_pulses``, ``labels/<k>``, ``node_labels/<k>`` sorted, then
        ``edges``, ``edge_mask``, ``event_weight`` where set)."""
        out = {"x": self.x, "mask": self.mask, "n_pulses": self.n_pulses}
        for k in sorted(self.labels):
            out[f"labels/{k}"] = self.labels[k]
        for k in sorted(self.node_labels):
            out[f"node_labels/{k}"] = self.node_labels[k]
        for name in ("edges", "edge_mask", "event_weight"):
            if getattr(self, name) is not None:
                out[name] = getattr(self, name)
        return out

    @classmethod
    def from_tensors(cls, tensors: Dict[str, torch.Tensor]) -> "EventBatch":
        """The inverse of :meth:`tensors`."""

        def prefixed(prefix):
            return {name[len(prefix):]: t for name, t in tensors.items()
                    if name.startswith(prefix)}

        return cls(
            x=tensors["x"], mask=tensors["mask"], n_pulses=tensors["n_pulses"],
            labels=prefixed("labels/"), node_labels=prefixed("node_labels/"),
            edges=tensors.get("edges"), edge_mask=tensors.get("edge_mask"),
            event_weight=tensors.get("event_weight"),
        )

    def signature(self) -> Tuple:
        """The name, dtype and shape of every tensor: batches with one
        signature stack into one :class:`StackedBatches`."""
        return tuple((name, t.dtype, tuple(t.shape))
                     for name, t in self.tensors().items())

    def to(self, device: DeviceLike) -> "EventBatch":
        """Copy of the batch with every tensor on ``device``."""
        return self.map(lambda t: t.to(device, non_blocking=True))

    @property
    def batch_size(self) -> int:
        return self.x.shape[0]

    @property
    def max_length(self) -> int:
        return self.x.shape[1]

    @property
    def num_features(self) -> int:
        return self.x.shape[2]


@dataclass
class StackedBatches:
    """k batches of one signature as one batch whose tensors carry a
    leading ``k`` dimension (``batches.x`` is ``[k, B, L, D]``).

    ``DataLoader(stack_k=k)`` and ``MaterializedLoader(stack_k=k)`` stack
    them on the host, so that the Trainer copies the k batches to its
    device at once and then runs k optimiser steps on views of them.
    """

    batches: EventBatch
    k: int

    @property
    def batch_size(self) -> int:
        """Events over the k batches."""
        return self.k * int(self.batches.x.shape[1])

    def unstack(self) -> List[EventBatch]:
        """The k batches (views of the stacked tensors)."""
        return [self.batches.map(lambda t, i=i: t[i]) for i in range(self.k)]

    def to(self, device: DeviceLike) -> "StackedBatches":
        return StackedBatches(batches=self.batches.to(device), k=self.k)


def stack_batches(batches: Sequence[EventBatch]) -> StackedBatches:
    """``torch.stack`` batches of one signature into a StackedBatches."""
    parts = [b.tensors() for b in batches]
    return StackedBatches(
        batches=EventBatch.from_tensors(
            {name: torch.stack([p[name] for p in parts]) for name in parts[0]}),
        k=len(batches),
    )


DEFAULT_BUCKETS: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_for_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket length >= n (last bucket truncates longer events)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_events(
    events: List[np.ndarray],
    length: Optional[int] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a list of ``[n_i, D]`` arrays to ``([B, L, D], [B, L], [B])``.

    Events longer than ``L`` are truncated.
    """
    if not events:
        raise ValueError("empty event list")
    d = events[0].shape[1]
    max_n = max(e.shape[0] for e in events)
    L = length if length is not None else bucket_for_length(max_n, buckets)
    B = len(events)
    x = np.zeros((B, L, d), dtype=np.float32)
    mask = np.zeros((B, L), dtype=bool)
    n_pulses = np.zeros((B,), dtype=np.int32)
    for i, e in enumerate(events):
        n = min(e.shape[0], L)
        x[i, :n] = e[:n]
        mask[i, :n] = True
        n_pulses[i] = n
    return x, mask, n_pulses


def make_batch(
    events: List[np.ndarray],
    labels: Optional[Dict[str, np.ndarray]] = None,
    node_labels: Optional[List[Dict[str, np.ndarray]]] = None,
    length: Optional[int] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
) -> EventBatch:
    """Build an :class:`EventBatch` of CPU tensors from per-event numpy
    arrays (move it with :meth:`EventBatch.to`)."""
    x, mask, n_pulses = pad_events(events, length=length, buckets=buckets)
    label_dict = {
        k: torch.as_tensor(np.asarray(v)) for k, v in (labels or {}).items()
    }
    nl_dict: Dict[str, torch.Tensor] = {}
    if node_labels:
        L = x.shape[1]
        for key in node_labels[0]:
            arr = np.zeros((len(events), L), dtype=np.float32)
            for i, dct in enumerate(node_labels):
                v = np.asarray(dct[key])
                n = min(v.shape[0], L)
                arr[i, :n] = v[:n]
            nl_dict[key] = torch.from_numpy(arr)
    return EventBatch(
        x=torch.from_numpy(x),
        mask=torch.from_numpy(mask),
        n_pulses=torch.from_numpy(n_pulses),
        labels=label_dict,
        node_labels=nl_dict,
    )
