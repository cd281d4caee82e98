"""ConvNet, a stack of topology-adaptive graph convolutions (TAGConv,
arXiv:1810.05165; counterpart of ``graphnet_tpu/models/gnn/convnet.py``).

On the dense layout the symmetrically normalised adjacency of the kNN
graph is a ``[B, L, L]`` matrix and each hop of a TAGConv one batched
matrix product.  Three convolutions, each pooled by sum and max over the
nodes; a batch norm over the events; five dense layers and the output
layer.
"""

from __future__ import annotations

import torch
from torch import nn

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.models.components.layers import ACTIVATIONS
from graphnet_tpu_torch.models.components.stochastic import Dropout
from graphnet_tpu_torch.models.gnn.gnn import GNN
from graphnet_tpu_torch.ops.gather_reduce import masked_max, masked_sum
from graphnet_tpu_torch.ops.knn import coordinate_view, knn_graph
from graphnet_tpu_torch.utils.config import save_config

_leaky_relu = ACTIVATIONS["leaky_relu"]


def adjacency_from_neighbors(
    idx: torch.Tensor, edge_mask: torch.Tensor, L: int
) -> torch.Tensor:
    """The directed adjacency ``A [B, L, L]``: ``A[b, i, j]`` counts the
    valid edges ``j -> i`` (``j`` among ``i``'s neighbours)."""
    B = idx.shape[0]
    A = torch.zeros((B, idx.shape[1], L), dtype=torch.float32,
                    device=idx.device)
    return A.scatter_add_(2, idx.long(), edge_mask.float())


def tag_normalised_adjacency(
    idx: torch.Tensor, edge_mask: torch.Tensor, L: int
) -> torch.Tensor:
    """``D^-1/2 A D^-1/2`` with ``D`` the in-degrees (PyG's ``gcn_norm``
    without self loops, as ``TAGConv`` uses it); a node without edges
    has a zero row and column."""
    A = adjacency_from_neighbors(idx, edge_mask, L)
    deg = A.sum(dim=-1)
    dis = torch.where(deg > 0, 1.0 / torch.sqrt(deg.clamp_min(1e-12)), 0.0)
    return A * dis[:, :, None] * dis[:, None, :]


class TAGConv(nn.Module):
    """``x' = sum_{h=0..K} W_h (A_norm)^h x``; the hops' biases are one,
    ``lin_0``'s."""

    def __init__(self, in_features: int, features: int, K: int = 2):
        super().__init__()
        self.K = K
        self.lin_0 = nn.Linear(in_features, features)
        for hop in range(1, K + 1):
            setattr(self, f"lin_{hop}",
                    nn.Linear(in_features, features, bias=False))

    def forward(self, x: torch.Tensor, A_norm: torch.Tensor) -> torch.Tensor:
        out = self.lin_0(x)
        h = x
        for hop in range(1, self.K + 1):
            h = torch.matmul(A_norm, h)
            out = out + getattr(self, f"lin_{hop}")(h)
        return out


class ConvNet(GNN):
    """Arguments and defaults are the JAX package's (``nb_outputs_`` its
    field name for the output width).

    The batch norm takes the statistics of the batch's events (the padding
    events a server adds included, as in the JAX package), or with
    ``frozen_batchnorm`` the stored ``bn_mean`` / ``bn_var``: torch's
    eval-mode statistics, which the porters fill from a GraphNeT
    checkpoint; in training too, as in the JAX package.  Dropout of
    ``dropout_ratio`` follows each of the five dense layers, on with
    ``deterministic=False`` in training mode."""

    @save_config
    def __init__(
        self,
        nb_inputs: int,
        nb_outputs_: int = 1,
        nb_intermediate: int = 128,
        dropout_ratio: float = 0.3,
        deterministic: bool = True,
        frozen_batchnorm: bool = False,
    ):
        super().__init__()
        self.nb_inputs = nb_inputs
        self.nb_outputs_ = nb_outputs_
        self.frozen_batchnorm = frozen_batchnorm
        inter2 = 6 * nb_intermediate
        d = nb_inputs
        for i in range(3):
            setattr(self, f"conv{i + 1}", TAGConv(d, nb_intermediate, K=2))
            d = nb_intermediate
        self.bn_scale = nn.Parameter(torch.ones(inter2))
        self.bn_bias = nn.Parameter(torch.zeros(inter2))
        if frozen_batchnorm:
            self.register_buffer("bn_mean", torch.zeros(inter2))
            self.register_buffer("bn_var", torch.ones(inter2))
        for i in range(5):
            setattr(self, f"linear{i + 1}", nn.Linear(inter2, inter2))
        self.out = nn.Linear(inter2, nb_outputs_)
        self.drop = Dropout(dropout_ratio, deterministic)

    @property
    def nb_outputs(self) -> int:
        return self.nb_outputs_

    def init_parameters(self, generator: torch.Generator) -> None:
        """The batch norm to the identity (flax's ones and zeros)."""
        with torch.no_grad():
            self.bn_scale.fill_(1.0)
            self.bn_bias.zero_()
            if self.frozen_batchnorm:
                self.bn_mean.zero_()
                self.bn_var.fill_(1.0)

    def forward(self, batch: EventBatch) -> torch.Tensor:
        x, mask = batch.x, batch.mask
        L = x.shape[1]
        if batch.edges is not None:
            idx, edge_mask = batch.edges, batch.edge_mask
        else:
            idx, edge_mask = knn_graph(coordinate_view(x, (0, 1, 2)), mask,
                                       k=8)
        A = tag_normalised_adjacency(idx, edge_mask, L)

        pools = []
        h = x
        for i in range(3):
            h = _leaky_relu(getattr(self, f"conv{i + 1}")(h, A))
            # padding nodes zeroed, so the sum pool is exact
            h = torch.where(mask[..., None], h, 0.0)
            pools.append(torch.cat([masked_sum(h, mask), masked_max(h, mask)],
                                   dim=1))
        z = torch.cat(pools, dim=1)
        if self.frozen_batchnorm:
            mean, var = self.bn_mean[None, :], self.bn_var[None, :]
        else:
            mean = z.mean(dim=0, keepdim=True)
            var = z.var(dim=0, unbiased=False, keepdim=True)
        z = (z - mean) / torch.sqrt(var + 1e-5) * self.bn_scale + self.bn_bias
        for i in range(5):
            z = self.drop(_leaky_relu(getattr(self, f"linear{i + 1}")(z)))
        return self.out(z)
