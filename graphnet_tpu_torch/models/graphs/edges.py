"""Edge definitions (counterpart of ``graphnet_tpu/models/graphs/edges.py``).
An edge definition is a rule evaluated on the device for a whole padded
batch, not a per-event edge list: ``build(x, mask) -> (idx [B, L, k],
edge_mask [B, L, k])``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from graphnet_tpu_torch.ops.knn import (
    coordinate_view,
    knn_graph,
    minkowski_knn_graph,
    pairwise_sq_dists,
    radius_graph,
)


@dataclass(frozen=True)
class EdgeDefinition:
    """Base edge rule: ``build(x, mask) -> (idx [B, L, k], edge_mask)``."""

    def build(
        self, x: torch.Tensor, mask: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


@dataclass(frozen=True)
class KNNEdges(EdgeDefinition):
    """kNN on selected columns (defaults: k=8 on x, y, z)."""

    nb_nearest_neighbours: int = 8
    columns: Tuple[int, ...] = (0, 1, 2)

    def build(self, x, mask):
        return knn_graph(
            coordinate_view(x, self.columns), mask,
            k=self.nb_nearest_neighbours,
        )


@dataclass(frozen=True)
class RadialEdges(EdgeDefinition):
    """Neighbours within a sphere of ``radius``, at most
    ``max_neighbours`` a node (the kNN kernel at that k on the card, then
    the radius on the chosen pairs)."""

    radius: float = 1.0
    columns: Tuple[int, ...] = (0, 1, 2)
    max_neighbours: int = 32

    def build(self, x, mask):
        return radius_graph(
            coordinate_view(x, self.columns), mask,
            r=self.radius, k=self.max_neighbours,
        )


@dataclass(frozen=True)
class MinkowskiKNNEdges(EdgeDefinition):
    """kNN under ``|dx|^2 - (c dt)^2`` (signed, ties to the lower index)."""

    nb_nearest_neighbours: int = 8
    c: float = 0.299792458
    time_like_weight: float = 1.0
    space_coords: Tuple[int, int, int] = (0, 1, 2)
    time_coord: int = 3

    def build(self, x, mask):
        return minkowski_knn_graph(
            x, mask, k=self.nb_nearest_neighbours, c=self.c,
            space_coords=self.space_coords, time_coord=self.time_coord,
        )


@dataclass(frozen=True)
class EuclideanEdges(EdgeDefinition):
    """Gaussian affinity ``exp(-d^2 / (2 sigma^2))`` over the valid pairs
    other than the node itself, normalised per row, its
    ``max_neighbours`` largest (ties to the lower index, as ``top_k``:
    a stable descending sort), and an edge where the normalised
    affinity exceeds ``threshold``."""

    sigma: float = 1.0
    threshold: float = 0.0
    columns: Tuple[int, ...] = (0, 1, 2)
    max_neighbours: int = 32

    def build(self, x, mask):
        coords = x[..., list(self.columns)]
        d2 = pairwise_sq_dists(coords, mask)
        affinity = torch.exp(-d2 / (2.0 * self.sigma ** 2))
        L = coords.shape[1]
        eye = torch.eye(L, dtype=torch.bool, device=x.device)[None]
        valid = mask[:, :, None] & mask[:, None, :] & ~eye
        affinity = torch.where(valid, affinity, 0.0)
        norm = affinity / affinity.sum(dim=-1, keepdim=True).clamp_min(1e-12)
        if self.max_neighbours > L:
            raise ValueError(f"max_neighbours={self.max_neighbours} of "
                             f"events of length {L}")
        chosen, idx = torch.sort(norm, dim=-1, descending=True, stable=True)
        chosen, idx = chosen[..., :self.max_neighbours], idx[..., :self.max_neighbours]
        edge_mask = (chosen > self.threshold) & mask[:, :, None]
        return idx.to(torch.int32), edge_mask
