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


def centre_coords_sequential(
    coords: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """:func:`centre_coords` with the centre summed over the valid nodes
    in index order in float64, divided by their count (at least 1) and
    rounded once to float32: a fixed order, which the fused EdgeConv +
    kNN kernel (``csrc/edgeconv_knn.cu``) follows, so both get the same
    bits on any device."""
    c = coords.float()
    s = torch.zeros(c.shape[0], c.shape[2], dtype=torch.float64,
                    device=c.device)
    for j in range(c.shape[1]):
        s = s + torch.where(mask[:, j, None], c[:, j].double(), 0.0)
    n = mask.sum(dim=1, keepdim=True).clamp_min(1).double()
    return c - (s / n).float()[:, None, :]


def sq_dists(c: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[B, L, D], [B, L] -> [B, L, L]`` squared distances of coordinates
    already centred; pairs with an invalid node get ``BIG``.

    The sums run over the coordinates in order, one rounding per product
    and per sum, so the result is bit-identical to the CUDA kernels'
    (which use the same non-fused arithmetic, ``csrc/knn.cuh``).
    """
    sq = c[..., 0] * c[..., 0]
    cross = c[:, :, None, 0] * c[:, None, :, 0]
    for d in range(1, c.shape[-1]):
        sq = sq + c[..., d] * c[..., d]
        cross = cross + c[:, :, None, d] * c[:, None, :, d]
    d2 = (sq[:, :, None] + sq[:, None, :]) - 2.0 * cross
    d2 = d2.clamp_min(0.0)
    valid = mask[:, :, None] & mask[:, None, :]
    return torch.where(valid, d2, BIG)


def pairwise_sq_dists(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[B, L, D], [B, L] -> [B, L, L]`` squared distances after
    :func:`centre_coords`; pairs with an invalid node get ``BIG``."""
    return sq_dists(centre_coords(coords.float(), mask), mask)


def select_knn(
    d2: torch.Tensor, mask: torch.Tensor, k: int, exclude_self: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest of each row of ``d2 [B, L, L]`` by a stable sort
    (ties to the lower index, as ``top_k``); a chosen distance of
    ``BIG / 2`` or more, or an invalid query, is no edge."""
    L = d2.shape[1]
    if k > L:
        raise ValueError(f"k={k} neighbours asked of events of length {L}")
    if exclude_self:
        eye = torch.eye(L, dtype=torch.bool, device=d2.device)
        d2 = d2.masked_fill(eye, BIG)
    chosen, idx = torch.sort(d2, dim=-1, stable=True)
    chosen, idx = chosen[..., :k], idx[..., :k]
    edge_mask = (chosen < BIG * 0.5) & mask[:, :, None]
    return idx.to(torch.int32), edge_mask


def knn_graph_plain(
    coords: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    exclude_self: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kNN: ``[B, L, L]`` distances, then the ``k`` smallest
    per row by a stable sort (ties to the lower index, as ``top_k``)."""
    return select_knn(pairwise_sq_dists(coords, mask), mask, k, exclude_self)


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
