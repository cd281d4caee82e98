"""Collation of events into padded batches (counterpart of
``collate_events`` in ``graphnet_tpu/data/dataloader.py``).

Padding is numpy on the host; the batch comes back as CPU tensors and
the caller moves it with :meth:`EventBatch.to`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from graphnet_tpu_torch.batch import (
    DEFAULT_BUCKETS,
    EventBatch,
    bucket_for_length,
)
from graphnet_tpu_torch.models.graphs.graph_definition import Event


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
    d = events[0].x.shape[1]
    max_n = max(e.n_pulses for e in events)
    L = length if length is not None else bucket_for_length(max_n, buckets)
    B = len(events)

    x = np.zeros((B, L, d), dtype=np.float32)
    mask = np.zeros((B, L), dtype=bool)
    n_pulses = np.zeros((B,), dtype=np.int32)
    for i, e in enumerate(events):
        n = min(e.n_pulses, L)
        x[i, :n] = e.x[:n]
        mask[i, :n] = True
        n_pulses[i] = n

    # labels common to every event, numeric only
    keys = set(events[0].labels)
    for e in events[1:]:
        keys &= set(e.labels)
    labels: Dict[str, torch.Tensor] = {}
    for k in sorted(keys):
        vals = [np.asarray(e.labels[k]) for e in events]
        if vals[0].dtype.kind not in "bifu":
            continue
        stacked = np.stack(vals)  # scalars -> [B]; vectors -> [B, d]
        labels[k] = torch.from_numpy(
            stacked.astype(
                np.float32 if stacked.dtype.kind == "f" else stacked.dtype
            )
        )

    node_labels: Dict[str, torch.Tensor] = {}
    nl_keys = set(events[0].node_labels)
    for e in events[1:]:
        nl_keys &= set(e.node_labels)
    for k in sorted(nl_keys):
        arr = np.zeros((B, L), dtype=np.float32)
        for i, e in enumerate(events):
            v = np.asarray(e.node_labels[k]).reshape(-1)
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
