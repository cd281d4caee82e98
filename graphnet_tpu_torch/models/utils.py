"""Model-level utilities on the dense-padded ``[B, L, D]`` layout
(counterpart of ``graphnet_tpu/models/utils.py``): distance matrices,
the xyzt homophily, kNN graphs with a per-event ``k`` (the kNN kernel on
the card), the bridge from packed ``[N, D]`` rows to the padded layout
and label fields of events."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from graphnet_tpu_torch.ops.gather_reduce import homophily
from graphnet_tpu_torch.ops.knn import knn_graph


def calculate_distance_matrix(xyz_coords: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances: ``[L, 3] -> [L, L]`` or ``[B, L, 3]
    -> [B, L, L]``."""
    diff = xyz_coords[..., :, None, :] - xyz_coords[..., None, :, :]
    return torch.sqrt((diff ** 2).sum(dim=-1))


def calculate_xyzt_homophily(
    x: torch.Tensor, idx: torch.Tensor, edge_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-event homophily of the first four node features (x, y, z, t)
    over the neighbour lists ``idx [B, L, k]``: four ``[B, 1]`` tensors."""
    h = homophily(idx, edge_mask, x[..., :4])
    return tuple(h[:, c:c + 1] for c in range(4))


def knn_graph_batch(
    coords: torch.Tensor,
    mask: torch.Tensor,
    k: Union[int, Sequence[int]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN edges with one ``k`` for all events or one for each: the graph
    at ``max(k)`` (one kNN launch on the card), each event's edges past
    its own ``k`` masked.  Returns ``[B, L, max_k]`` indices and mask."""
    ks = np.atleast_1d(np.asarray(k, dtype=np.int64))
    B = coords.shape[0]
    if ks.shape[0] not in (1, B):
        raise ValueError(
            f"k must be a scalar or one per event: got {ks.shape[0]} "
            f"values for batch size {B}")
    max_k = int(ks.max())
    idx, edge_mask = knn_graph(coords, mask, max_k)
    per_event = torch.as_tensor(np.broadcast_to(ks, (B,)).copy(),
                                device=coords.device)
    rank = torch.arange(max_k, device=coords.device)[None, None, :]
    return idx, edge_mask & (rank < per_event[:, None, None])


def array_to_sequence(
    x: np.ndarray,
    batch_idx: np.ndarray,
    padding_value: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Packed rows ``x [N, D]`` grouped by a non-decreasing event index
    ``batch_idx [N]`` -> ``(x_padded [B, L, D], mask [B, L], seq_length
    [B])`` (host side, numpy)."""
    x = np.asarray(x)
    batch_idx = np.asarray(batch_idx)
    if np.any(np.diff(batch_idx) < 0):
        raise ValueError("batch_idx must be non-decreasing")
    uniq, seq_length = np.unique(batch_idx, return_counts=True)
    B, L, D = len(uniq), int(seq_length.max()), x.shape[1]
    out = np.full((B, L, D), padding_value, dtype=x.dtype)
    mask = np.zeros((B, L), dtype=bool)
    start = 0
    for b, n in enumerate(seq_length):
        out[b, :n] = x[start:start + n]
        mask[b, :n] = True
        start += n
    return out, mask, seq_length


def get_fields(
    events: Union[Any, List[Any]], fields: List[str]
) -> np.ndarray:
    """Named label fields of one or more events (``Event``s or dicts)
    stacked as ``[B, F]``; an ``Event`` attribute serves where its labels
    lack the name."""
    if not isinstance(events, list):
        events = [events]

    def value(ev: Any, name: str) -> np.ndarray:
        src: Dict[str, Any]
        if isinstance(ev, dict):
            src = ev
        else:
            src = getattr(ev, "labels", None) or {}
            if name not in src and hasattr(ev, name):
                return np.asarray(getattr(ev, name)).reshape(-1)
        if name not in src:
            raise KeyError(f"field {name!r} not found on event")
        return np.asarray(src[name]).reshape(-1)

    cols = [np.concatenate([value(ev, f) for ev in events]) for f in fields]
    return np.stack(cols, axis=1)
