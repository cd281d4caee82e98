"""Batched k-nearest-neighbour graphs on dense-padded events
(counterpart of ``graphnet_tpu/ops/knn.py``).

Semantics of the JAX package (``torch_cluster.knn_graph(loop=False)``):
self-edges excluded, ties broken toward the lower index, coordinates
centred per event before the ``|a|^2 + |b|^2 - 2ab`` expansion, and
events with fewer than ``k + 1`` valid nodes reporting the missing
neighbours through ``edge_mask``.

A tensor on the CPU takes the plain PyTorch path; a CUDA tensor takes
the CUDA kernel (:mod:`graphnet_tpu_torch.ops.knn_cuda`).
"""

from __future__ import annotations

from typing import Tuple

import torch

BIG = 1e30


def centre_coords(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Subtract each event's mean over its valid nodes (neighbour ranking
    is translation invariant; centring cuts fp32 cancellation)."""
    denom = mask.sum(dim=1, keepdim=True).clamp_min(1)  # [B, 1]
    centre = torch.where(mask[..., None], coords, 0.0).sum(dim=1) / denom
    return coords - centre[:, None, :]


def pairwise_sq_dists(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[B, L, D], [B, L] -> [B, L, L]`` squared distances; pairs with an
    invalid node get ``BIG``.

    The sums run over the coordinates in order, one rounding per product
    and per sum, so the result is bit-identical to the CUDA kernel's
    (which uses the same non-fused arithmetic).
    """
    c = centre_coords(coords.float(), mask)
    sq = c[..., 0] * c[..., 0]
    cross = c[:, :, None, 0] * c[:, None, :, 0]
    for d in range(1, c.shape[-1]):
        sq = sq + c[..., d] * c[..., d]
        cross = cross + c[:, :, None, d] * c[:, None, :, d]
    d2 = (sq[:, :, None] + sq[:, None, :]) - 2.0 * cross
    d2 = d2.clamp_min(0.0)
    valid = mask[:, :, None] & mask[:, None, :]
    return torch.where(valid, d2, BIG)


def knn_graph_plain(
    coords: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    exclude_self: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kNN: ``[B, L, L]`` distances, then the ``k`` smallest
    per row by a stable sort (ties to the lower index, as ``top_k``)."""
    B, L, _ = coords.shape
    if k > L:
        raise ValueError(f"k={k} neighbours asked of events of length {L}")
    d2 = pairwise_sq_dists(coords, mask)
    if exclude_self:
        eye = torch.eye(L, dtype=torch.bool, device=coords.device)
        d2 = d2.masked_fill(eye, BIG)
    chosen, idx = torch.sort(d2, dim=-1, stable=True)
    chosen, idx = chosen[..., :k], idx[..., :k]
    edge_mask = (chosen < BIG * 0.5) & mask[:, :, None]
    return idx.to(torch.int32), edge_mask


def knn_graph(
    coords: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    exclude_self: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched kNN on padded point sets.

    Args:
        coords: ``[B, L, D]`` positions (already sliced to the kNN
            feature subset, e.g. xyz).
        mask: ``[B, L]`` validity mask.
        k: number of neighbours.

    Returns:
        ``(indices, edge_mask)``: ``[B, L, k]`` int32 neighbour indices
        (arbitrary, but in range, where ``edge_mask`` is False) and the
        ``[B, L, k]`` bool mask of real edges (valid source, valid and
        distinct neighbour).
    """
    from graphnet_tpu_torch.ops.knn_cuda import knn_graph_cuda

    return knn_graph_cuda(coords, mask, k, exclude_self)
