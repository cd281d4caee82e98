"""Edge definitions (counterpart of ``graphnet_tpu/models/graphs/edges.py``;
:class:`KNNEdges` so far).  An edge definition is a rule evaluated on
the device for a whole padded batch, not a per-event edge list."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from graphnet_tpu_torch.ops.knn import coordinate_view, knn_graph


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
