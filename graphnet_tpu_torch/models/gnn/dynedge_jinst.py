"""DynEdgeJINST, the architecture of the IceCube low-energy
reconstruction paper (arXiv:2209.03042; counterpart of
``graphnet_tpu/models/gnn/dynedge_jinst.py``).

One kNN graph on x, y, z (k = 8) and the homophily of x, y, z, t on it;
four DynEdge convolutions with add aggregation and leaky ReLU, each
rebuilding the kNN graph on its output latents; the skip-concat of the
input and every conv output through ``nn1`` and ``nn2``; max, min, sum
and mean pooling beside the homophilies and the pulse count; ``nn3``.
"""

from __future__ import annotations

import torch
from torch import nn

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.models.components.layers import (
    ACTIVATIONS,
    DynEdgeConv,
)
from graphnet_tpu_torch.models.gnn.gnn import GNN
from graphnet_tpu_torch.ops.gather_reduce import (
    homophily,
    masked_max,
    masked_mean,
    masked_min,
    masked_sum,
)
from graphnet_tpu_torch.ops.knn import coordinate_view, knn_graph
from graphnet_tpu_torch.utils.config import save_config

_leaky_relu = ACTIVATIONS["leaky_relu"]


class DynEdgeJINST(GNN):
    """Arguments and defaults are the JAX package's: the widths are
    ``layer_size_scale`` times 32, 64, 84, 64 and 32."""

    @save_config
    def __init__(self, nb_inputs: int, layer_size_scale: int = 4):
        super().__init__()
        self.nb_inputs = nb_inputs
        self.layer_size_scale = layer_size_scale
        c = layer_size_scale
        l2, l3, l4, l5, l6 = c * 32, c * 64, c * 84, c * 64, c * 32
        for i, (d_in, sizes) in enumerate(
            ((nb_inputs, (l2, l3)), (l3, (l4, l3)), (l3, (l4, l3)),
             (l3, (l4, l3))), start=1):
            setattr(self, f"conv_add{i}", DynEdgeConv(
                d_in, sizes, aggr="add", nb_neighbors=8,
                activation="leaky_relu"))
        self.nn1 = nn.Linear(nb_inputs + 4 * l3, l4)
        self.nn2 = nn.Linear(l4, l5)
        self.nn3 = nn.Linear(4 * l5 + 5, l6)

    @property
    def nb_outputs(self) -> int:
        return self.layer_size_scale * 32

    def forward(self, batch: EventBatch) -> torch.Tensor:
        x, mask = batch.x, batch.mask
        if batch.edges is not None:
            idx, edge_mask = batch.edges, batch.edge_mask
        else:
            idx, edge_mask = knn_graph(coordinate_view(x, (0, 1, 2)), mask,
                                       k=8)
        homs = homophily(idx, edge_mask, x[..., :4])  # [B, 4]: x, y, z, t

        outs = [x]
        h = x
        for i in range(1, 5):
            h, idx, edge_mask = getattr(self, f"conv_add{i}")(
                h, mask, idx, edge_mask)
            outs.append(h)
        h = _leaky_relu(self.nn1(torch.cat(outs, dim=-1)))
        h = self.nn2(h)
        pooled = torch.cat(
            [
                masked_max(h, mask),
                masked_min(h, mask),
                masked_sum(h, mask),
                masked_mean(h, mask),
                homs[:, 3:4],
                homs[:, 0:3],
                batch.n_pulses.to(h.dtype)[:, None],
            ],
            dim=-1,
        )
        return _leaky_relu(self.nn3(_leaky_relu(pooled)))
