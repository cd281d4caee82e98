"""ParticleNeT, EdgeConv blocks with batch norm and mean aggregation
(arXiv:1902.08570; counterpart of ``graphnet_tpu/models/gnn/particlenet.py``).

Each block gathers its messages, runs ``[dense, batch norm, activation]``
per layer over the ``[B, L, k, d]`` edges and takes the mean over the
valid ones; with ``dynamic`` each block's output rebuilds the kNN graph
(k = 16) for the next.  The batch norm's statistics are those of the
batch's valid edges, or with ``frozen_batchnorm`` the stored ones
(torch's eval mode, which the porters fill from a GraphNeT checkpoint).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.models.components.layers import resolve_activation
from graphnet_tpu_torch.models.components.stochastic import Dropout
from graphnet_tpu_torch.models.gnn.gnn import GNN
from graphnet_tpu_torch.ops.gather_reduce import (
    edge_reduce,
    gather_neighbors,
    global_pool,
)
from graphnet_tpu_torch.ops.knn import coordinate_view, knn_graph
from graphnet_tpu_torch.utils.config import save_config


class MaskedBatchNorm(nn.Module):
    """Batch norm over the last axis with the statistics of the valid
    (masked) elements only, or with ``frozen`` the stored ``mean`` and
    ``var`` (buffers: no optimiser moves them)."""

    def __init__(self, features: int, frozen: bool = False):
        super().__init__()
        self.frozen = frozen
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        if frozen:
            self.register_buffer("mean", torch.zeros(features))
            self.register_buffer("var", torch.ones(features))

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            if self.frozen:
                self.mean.zero_()
                self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.frozen:
            mean, var = self.mean, self.var
        else:
            axes = tuple(range(x.dim() - 1))
            m = mask[..., None].to(x.dtype)
            n = m.sum().clamp_min(1.0)
            mean = (x * m).sum(dim=axes) / n
            var = ((x - mean) ** 2 * m).sum(dim=axes) / n
        return (x - mean) / torch.sqrt(var + 1e-5) * self.scale + self.bias


class ParticleNeTConv(nn.Module):
    """EdgeConv with ``[dense, batch norm, activation]`` layers; the first
    dense linearised as the port's EdgeConv's (``self_dense`` on x_i,
    ``nbr_dense`` on x_j)."""

    def __init__(
        self,
        in_features: int,
        nn_sizes: Sequence[int],
        aggr: str = "mean",
        activation: str = "relu",
        add_batchnorm: bool = True,
        frozen_batchnorm: bool = False,
    ):
        super().__init__()
        self.nn_sizes = tuple(nn_sizes)
        self.aggr = aggr
        self.act = resolve_activation(activation)
        self.add_batchnorm = add_batchnorm
        h0 = self.nn_sizes[0]
        self.self_dense = nn.Linear(in_features, h0)
        self.nbr_dense = nn.Linear(in_features, h0, bias=False)
        d = h0
        for i, size in enumerate(self.nn_sizes):
            if i > 0:
                setattr(self, f"dense_{i}", nn.Linear(d, size))
            if add_batchnorm:
                setattr(self, f"bn_{i}", MaskedBatchNorm(size,
                                                         frozen_batchnorm))
            d = size

    def forward(self, x: torch.Tensor, idx: torch.Tensor,
                edge_mask: torch.Tensor) -> torch.Tensor:
        a = self.self_dense(x)
        b = self.nbr_dense(x)
        h = a[:, :, None, :] + gather_neighbors(b, idx)
        for i in range(len(self.nn_sizes)):
            if i > 0:
                h = getattr(self, f"dense_{i}")(h)
            if self.add_batchnorm:
                h = getattr(self, f"bn_{i}")(h, edge_mask)
            h = self.act(h)
        return edge_reduce(h, edge_mask, self.aggr)


class ParticleNeT(GNN):
    """Arguments and defaults are the JAX package's.  Empty
    ``global_pooling_schemes`` gives node-level outputs (the readout per
    node).  Dropout of ``dropout_readout`` follows each readout layer, on
    with ``deterministic=False`` in training mode; the batch norms take
    the batch's statistics unless frozen, in training too, as in the JAX
    package."""

    @save_config
    def __init__(
        self,
        nb_inputs: int,
        nb_neighbours: int = 16,
        features_subset: Tuple[int, ...] = (0, 1, 2),
        dynamic: bool = True,
        dynedge_layer_sizes: Tuple[Tuple[int, ...], ...] = (
            (64, 64, 64),
            (128, 128, 128),
            (256, 256, 256),
        ),
        readout_layer_sizes: Tuple[int, ...] = (256,),
        global_pooling_schemes: Optional[Tuple[str, ...]] = ("mean",),
        activation_layer: str = "relu",
        add_batchnorm_layer: bool = True,
        dropout_readout: float = 0.1,
        skip_readout: bool = False,
        deterministic: bool = True,
        frozen_batchnorm: bool = False,
    ):
        super().__init__()
        if isinstance(global_pooling_schemes, str):
            global_pooling_schemes = (global_pooling_schemes,)
        self.nb_inputs = nb_inputs
        self.nb_neighbours = nb_neighbours
        self.features_subset = list(features_subset)
        self.dynamic = dynamic
        self.readout_layer_sizes = tuple(readout_layer_sizes)
        self.global_pooling_schemes = global_pooling_schemes
        self.add_batchnorm_layer = add_batchnorm_layer
        self.skip_readout = skip_readout
        self.frozen_batchnorm = frozen_batchnorm
        self.act = resolve_activation(activation_layer)
        d = nb_inputs
        self.n_convs = len(dynedge_layer_sizes)
        for i, sizes in enumerate(dynedge_layer_sizes):
            setattr(self, f"conv_{i}", ParticleNeTConv(
                d, tuple(sizes), aggr="mean", activation=activation_layer,
                add_batchnorm=add_batchnorm_layer,
                frozen_batchnorm=frozen_batchnorm))
            d = sizes[-1]
        self.latent_dim = d
        if global_pooling_schemes:
            d *= len(global_pooling_schemes)
        for i, size in enumerate(self.readout_layer_sizes):
            setattr(self, f"readout_{i}", nn.Linear(d, size))
            d = size
        self.drop = Dropout(dropout_readout, deterministic)

    @property
    def nb_outputs(self) -> int:
        if self.skip_readout:
            return self.latent_dim
        return self.readout_layer_sizes[-1]

    def _knn(self, x: torch.Tensor, mask: torch.Tensor):
        return knn_graph(coordinate_view(x, self.features_subset), mask,
                         k=self.nb_neighbours)

    def forward(self, batch: EventBatch) -> torch.Tensor:
        x, mask = batch.x, batch.mask
        if batch.edges is not None:
            idx, edge_mask = batch.edges, batch.edge_mask
        else:
            idx, edge_mask = self._knn(x, mask)
        for i in range(self.n_convs):
            x = getattr(self, f"conv_{i}")(x, idx, edge_mask)
            if self.dynamic:
                idx, edge_mask = self._knn(x, mask)
        if self.skip_readout:
            return x
        h = (global_pool(x, mask, self.global_pooling_schemes)
             if self.global_pooling_schemes else x)
        for i in range(len(self.readout_layer_sizes)):
            h = self.drop(self.act(getattr(self, f"readout_{i}")(h)))
        return h
