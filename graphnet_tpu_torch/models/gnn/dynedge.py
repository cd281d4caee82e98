"""DynEdge, the flagship backbone (counterpart of
``graphnet_tpu/models/gnn/dynedge.py``).

  * global variables (xyzt homophily + per-event feature means + log10
    n_pulses) are broadcast to the nodes;
  * 4 DynEdgeConv blocks, each re-running kNN on its output latents;
  * skip-concat of all conv outputs, post-processing MLP, multi-scheme
    global pooling (masked reductions), readout MLP.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.models.components.layers import (
    MLP,
    DynEdgeConv,
    sharded_knn_graph,
)
from graphnet_tpu_torch.models.gnn.gnn import GNN, resolve_compute_dtype
from graphnet_tpu_torch.ops.gather_reduce import (
    broadcast_to_nodes,
    global_pool,
    homophily,
)
from graphnet_tpu_torch.ops.knn import coordinate_view, knn_graph
from graphnet_tpu_torch.parallel.graph_sharding import current_graph_axis
from graphnet_tpu_torch.utils.config import save_config

DEFAULT_DYNEDGE_LAYER_SIZES: Tuple[Tuple[int, ...], ...] = (
    (128, 256),
    (336, 256),
    (336, 256),
    (336, 256),
)


class DynEdge(GNN):
    """Dynamical-edge-convolution GNN.

    Arguments and defaults are the JAX package's.  ``compute_dtype``
    ("bfloat16" or None) is the dtype of the conv and MLP matrix
    products; kNN distances, pooling and the readout stay fp32.
    """

    @save_config
    def __init__(
        self,
        nb_inputs: int,
        nb_neighbours: int = 8,
        features_subset: Tuple[int, ...] = (0, 1, 2),
        dynedge_layer_sizes: Tuple[Tuple[int, ...], ...] = (
            DEFAULT_DYNEDGE_LAYER_SIZES
        ),
        post_processing_layer_sizes: Tuple[int, ...] = (336, 256),
        readout_layer_sizes: Tuple[int, ...] = (128,),
        global_pooling_schemes: Optional[Tuple[str, ...]] = (
            "min",
            "max",
            "mean",
            "sum",
        ),
        add_global_variables_after_pooling: bool = False,
        activation_layer: str = "relu",
        add_norm_layer: bool = False,
        skip_readout: bool = False,
        compute_dtype: Optional[str] = None,
    ):
        super().__init__()
        self.nb_inputs = nb_inputs
        self.nb_neighbours = nb_neighbours
        self.features_subset = list(features_subset)
        self.readout_layer_sizes = tuple(readout_layer_sizes)
        if isinstance(global_pooling_schemes, str):
            global_pooling_schemes = (global_pooling_schemes,)
        self.global_pooling_schemes = global_pooling_schemes
        self.add_global_variables_after_pooling = (
            add_global_variables_after_pooling
        )
        self.skip_readout = skip_readout
        self.compute_dtype = compute_dtype
        dtype = resolve_compute_dtype(compute_dtype)

        # means [nb_inputs] + homophily of up to 4 columns + log10 n_pulses
        n_global = nb_inputs + min(4, nb_inputs) + 1
        d = nb_inputs + (0 if add_global_variables_after_pooling else n_global)
        d_skip = d
        self.n_convs = len(dynedge_layer_sizes)
        for i, sizes in enumerate(dynedge_layer_sizes):
            setattr(
                self,
                f"conv_{i}",
                DynEdgeConv(
                    d,
                    tuple(sizes),
                    aggr="add",
                    nb_neighbors=nb_neighbours,
                    features_subset=features_subset,
                    activation=activation_layer,
                    add_norm_layer=add_norm_layer,
                    dtype=dtype,
                ),
            )
            d = sizes[-1]
            d_skip += d
        self.post_processing = MLP(
            d_skip,
            post_processing_layer_sizes,
            activation=activation_layer,
            add_norm_layer=add_norm_layer,
            dtype=dtype,
        )
        if not skip_readout:
            d = post_processing_layer_sizes[-1]
            if global_pooling_schemes:
                d *= len(global_pooling_schemes)
                if add_global_variables_after_pooling:
                    d += n_global
            self.readout = MLP(
                d, readout_layer_sizes, activation=activation_layer
            )

    @property
    def nb_outputs(self) -> int:
        if self.skip_readout:
            return self.post_processing.sizes[-1]
        return self.readout_layer_sizes[-1]

    def _global_variables(
        self,
        x: torch.Tensor,
        mask: torch.Tensor,
        idx: torch.Tensor,
        edge_mask: torch.Tensor,
        n_pulses: torch.Tensor,
    ) -> torch.Tensor:
        """Masked feature means + homophily of xyzt + log10(n_pulses);
        under node sharding over every process's rows of the event."""
        axis = current_graph_axis()
        homs = homophily(idx, edge_mask, x[..., :4], axis=axis)
        means = global_pool(x, mask, "mean", axis=axis)
        logn = torch.log10(n_pulses.clamp_min(1).to(x.dtype))[:, None]
        return torch.cat([means, homs, logn], dim=-1)

    def forward(self, batch: EventBatch) -> torch.Tensor:
        x, mask = batch.x, batch.mask

        # initial adjacency: precomputed edges if the batch carries them,
        # else kNN on the configured coordinate columns
        if batch.edges is not None:
            idx, edge_mask = batch.edges, batch.edge_mask
        else:
            idx, edge_mask = sharded_knn_graph(
                coordinate_view(x, self.features_subset), mask,
                k=self.nb_neighbours, knn=knn_graph,
            )

        global_variables = self._global_variables(
            x, mask, idx, edge_mask, batch.n_pulses
        )
        if not self.add_global_variables_after_pooling:
            x = torch.cat(
                [x, broadcast_to_nodes(global_variables, x.shape[1])], dim=-1
            )

        skip_connections = [x]
        for i in range(self.n_convs):
            x, idx, edge_mask = getattr(self, f"conv_{i}")(
                x, mask, idx, edge_mask
            )
            skip_connections.append(x)

        x = torch.cat(skip_connections, dim=-1)
        x = self.post_processing(x).float()

        if self.skip_readout:
            return x

        if self.global_pooling_schemes:
            x = global_pool(x, mask, self.global_pooling_schemes,
                            axis=current_graph_axis())
            if self.add_global_variables_after_pooling:
                x = torch.cat([x, global_variables], dim=-1)

        return self.readout(x)
