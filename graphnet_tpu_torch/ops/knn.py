"""Batched k-nearest-neighbour graphs on dense-padded events
(counterpart of ``graphnet_tpu/ops/knn.py``).

Semantics of the JAX package (``torch_cluster.knn_graph(loop=False)``):
self-edges excluded, ties broken toward the lower index, coordinates
centred per event before the ``|a|^2 + |b|^2 - 2ab`` expansion, and
events with fewer than ``k + 1`` valid nodes reporting the missing
neighbours through ``edge_mask``.  The centre is summed in float64 in
index order (:func:`event_centre`), a rule the kernels follow bit for
bit.

A tensor on the CPU takes the plain PyTorch path; a CUDA tensor takes
the CUDA kernel (:mod:`graphnet_tpu_torch.ops.knn_cuda`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

BIG = 1e30


def event_centre(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[B, L, D], [B, L] -> [B, D]`` float32 centre of each event: the
    sum of the valid nodes' coordinates in index order in float64,
    divided by their count (at least 1) and rounded once to float32.  A
    fixed order, which the kNN kernels (``csrc/knn.cu``, and the fused
    EdgeConv + kNN ``csrc/edgeconv_knn.cu``) follow, so all get the same
    bits on any device.

    As ``csrc/knn.cu`` (its note proves it), a coordinate whose valid
    non-zero values pass the exponent test is summed in one vectorised
    float64 sum, every addition of which is exact, so any order gives
    the serial sum's bits; the others take the serial sum, a float64
    ``cumsum`` on the CPU (a scan in index order there)."""
    c = torch.where(mask[..., None], coords.float(), 0.0)
    n = mask.sum(dim=1, keepdim=True).clamp_min(1)
    e = ((c.view(torch.int32) >> 23) & 0xFF).clamp_min(1)
    nz = c != 0
    lo = torch.where(nz, e, 255).amin(dim=1)
    hi = torch.where(nz, e, 0).amax(dim=1)
    clog = torch.log2(n.double()).ceil().long()  # exact for n <= 2^52
    exact = (hi < 255) & (hi - lo + 24 + clog <= 53)
    s = c.double().sum(dim=1) + 0.0
    if not bool(exact.all()):
        serial = c.double().cpu().cumsum(dim=1)[:, -1].to(c.device)
        s = torch.where(exact, s, serial)
    return (s / n.double()).float()


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
    subtracting each event's :func:`event_centre` in float32 (neighbour
    ranking is translation invariant; centring cuts fp32 cancellation);
    pairs with an invalid node get ``BIG``."""
    c = coords.float() - event_centre(coords, mask)[:, None, :]
    return sq_dists(c, mask)


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


def coordinate_view(x: torch.Tensor, columns: Sequence[int]) -> torch.Tensor:
    """``x[..., columns]``: a view (no copy) where ``columns`` is a
    contiguous ascending range, as the kNN kernel reads coordinates where
    they lie; an index copy otherwise."""
    cols = list(columns)
    lo = cols[0]
    if cols == list(range(lo, lo + len(cols))):
        return x[..., lo:lo + len(cols)]
    return x[..., cols]


def knn_graph(
    coords: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    exclude_self: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched kNN on padded point sets.

    Args:
        coords: ``[B, L, D]`` positions (already sliced to the kNN
            feature subset, e.g. xyz; a strided view such as
            :func:`coordinate_view`'s is read in place on the card).
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


def chosen_sq_dists(
    coords: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """``[B, L, k]`` squared distances of the pairs ``(i, idx[i])``, centred
    by :func:`event_centre` and in :func:`sq_dists`' arithmetic, so each
    equals its entry of :func:`pairwise_sq_dists` bit for bit without the
    ``[B, L, L]`` matrix (``BIG`` where either node is invalid)."""
    c = coords.float() - event_centre(coords, mask)[:, None, :]
    B, L, D = c.shape
    k = idx.shape[-1]
    flat = idx.long().reshape(B, L * k, 1)
    nb = torch.gather(c, 1, flat.expand(-1, -1, D)).reshape(B, L, k, D)
    q = c[:, :, None, :]
    sq_q, sq_n = q[..., 0] * q[..., 0], nb[..., 0] * nb[..., 0]
    cross = q[..., 0] * nb[..., 0]
    for d in range(1, D):
        sq_q = sq_q + q[..., d] * q[..., d]
        sq_n = sq_n + nb[..., d] * nb[..., d]
        cross = cross + q[..., d] * nb[..., d]
    d2 = ((sq_q + sq_n) - 2.0 * cross).clamp_min(0.0)
    nb_valid = torch.gather(mask, 1, flat[..., 0]).reshape(B, L, k)
    return torch.where(mask[:, :, None] & nb_valid, d2, BIG)


def radius_graph(
    coords: torch.Tensor, mask: torch.Tensor, r: float, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbours within radius ``r``, at most ``k`` a node (the JAX
    package's ``radius_graph``): :func:`knn_graph` at ``k`` (the kNN kernel
    on the card), then ``d2 <= r^2`` on the chosen pairs."""
    idx, edge_mask = knn_graph(coords, mask, k, exclude_self=True)
    d2 = chosen_sq_dists(coords, mask, idx)
    return idx, edge_mask & (d2 <= r * r)


def minkowski_knn_graph(
    coords_xyzt: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    c: float = 0.299792458,
    space_coords: Tuple[int, int, int] = (0, 1, 2),
    time_coord: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN under the signed pseudo-metric ``|dx|^2 - (c dt)^2`` (the JAX
    package's ``minkowski_knn_graph``): the plain ``[B, L, L]`` values,
    ranked signed (no clamping), the ``k`` smallest by a stable sort, so
    ties go to the lower index.  The sums run over the coordinates in
    order, one rounding per product and per sum."""
    xyz = coords_xyzt[..., list(space_coords)].float()
    t = coords_xyzt[..., time_coord].float() * c
    sq = xyz[..., 0] * xyz[..., 0]
    cross = xyz[:, :, None, 0] * xyz[:, None, :, 0]
    for d in range(1, xyz.shape[-1]):
        sq = sq + xyz[..., d] * xyz[..., d]
        cross = cross + xyz[:, :, None, d] * xyz[:, None, :, d]
    sq = sq - t * t
    cross = cross - t[:, :, None] * t[:, None, :]
    d2 = (sq[:, :, None] + sq[:, None, :]) - 2.0 * cross
    valid = mask[:, :, None] & mask[:, None, :]
    return select_knn(torch.where(valid, d2, BIG), mask, k, exclude_self=True)
