"""DynEdgeTITO: DynTrans blocks (EdgeConv + a masked transformer layer)
on a static kNN graph (counterpart of
``graphnet_tpu/models/gnn/dynedge_kaggle_tito.py``).

The kNN graph is built once, from the input coordinates of
``features_subset`` (x, y, z, t by default), and reused by every block;
unlike DynEdge the blocks do not rebuild it.  Global variables
(feature means, homophily of x, y, z, t, log10 n_pulses) are appended
after pooling.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.models.components.layers import MLP, DynTrans
from graphnet_tpu_torch.models.gnn.gnn import GNN, resolve_compute_dtype
from graphnet_tpu_torch.ops.gather_reduce import (
    global_pool,
    homophily,
    masked_mean,
)
from graphnet_tpu_torch.ops.knn import coordinate_view, knn_graph
from graphnet_tpu_torch.utils.config import save_config


class DynEdgeTITO(GNN):
    """Arguments and defaults are the JAX package's.  ``compute_dtype``
    ("bfloat16" or None) is the dtype of the blocks' matrix products;
    the layer norms, the kNN, the post-processing and readout MLPs and
    the pooling stay fp32.  ``dropout_rate`` is each encoder layer's
    dropout (torch's: the attention probabilities, which then take the
    dense path, both residual branches and the feed-forward), on with
    ``deterministic=False`` in training mode; the default 0 is GraphNeT's
    eval behaviour."""

    @save_config
    def __init__(
        self,
        nb_inputs: int,
        features_subset: Tuple[int, ...] = (0, 1, 2, 3),
        dyntrans_layer_sizes: Tuple[Tuple[int, ...], ...] = (
            (256, 256),
            (256, 256),
            (256, 256),
            (256, 256),
        ),
        global_pooling_schemes: Tuple[str, ...] = ("max",),
        use_global_features: bool = True,
        use_post_processing_layers: bool = True,
        post_processing_layer_sizes: Tuple[int, ...] = (336, 256),
        readout_layer_sizes: Tuple[int, ...] = (256, 128),
        n_head: int = 8,
        nb_neighbours: int = 8,
        dropout_rate: float = 0.0,
        deterministic: bool = True,
        compute_dtype: Optional[str] = None,
    ):
        super().__init__()
        if isinstance(global_pooling_schemes, str):
            global_pooling_schemes = (global_pooling_schemes,)
        # the reference equally rejects empty pooling
        # (`dynedge_kaggle_tito.py:202` asserts)
        assert global_pooling_schemes, (
            "DynEdgeTITO requires at least one global pooling scheme"
        )
        self.nb_inputs = nb_inputs
        self.features_subset = list(features_subset)
        self.global_pooling_schemes = tuple(global_pooling_schemes)
        self.use_global_features = use_global_features
        self.use_post_processing_layers = use_post_processing_layers
        self.readout_layer_sizes = tuple(readout_layer_sizes)
        self.nb_neighbours = nb_neighbours
        self.deterministic = deterministic
        self.compute_dtype = compute_dtype
        dtype = resolve_compute_dtype(compute_dtype)

        latent = nb_inputs
        self.n_convs = len(dyntrans_layer_sizes)
        for i, sizes in enumerate(dyntrans_layer_sizes):
            setattr(
                self,
                f"conv_{i}",
                DynTrans(
                    layer_sizes=(latent,) + tuple(sizes),
                    aggr="max",
                    n_head=n_head,
                    dropout_rate=dropout_rate,
                    deterministic=deterministic,
                    dtype=dtype,
                ),
            )
            latent = sizes[-1]
        if use_post_processing_layers:
            self.post_processing = MLP(
                latent, post_processing_layer_sizes, activation="leaky_relu"
            )
            latent = post_processing_layer_sizes[-1]
        d = latent * len(self.global_pooling_schemes)
        if use_global_features:
            # means [nb_inputs] + homophily of up to 4 columns + log10 n
            d += nb_inputs + min(4, nb_inputs) + 1
        self.readout = MLP(d, readout_layer_sizes, activation="leaky_relu")

    @property
    def nb_outputs(self) -> int:
        return self.readout_layer_sizes[-1]

    def forward(self, batch: EventBatch) -> torch.Tensor:
        x, mask = batch.x, batch.mask
        if batch.edges is not None:
            idx, edge_mask = batch.edges, batch.edge_mask
        else:
            idx, edge_mask = knn_graph(
                coordinate_view(x, self.features_subset), mask,
                k=self.nb_neighbours,
            )

        if self.use_global_features:
            homs = homophily(idx, edge_mask, x[..., :4])
            means = masked_mean(x, mask)
            logn = torch.log10(batch.n_pulses.clamp_min(1).to(x.dtype))[:, None]
            global_variables = torch.cat([means, homs, logn], dim=-1)

        for i in range(self.n_convs):
            x = getattr(self, f"conv_{i}")(x, mask, idx, edge_mask)
        if self.use_post_processing_layers:
            x = self.post_processing(x)
        x = global_pool(x, mask, self.global_pooling_schemes)
        if self.use_global_features:
            x = torch.cat([x, global_variables], dim=-1)
        return self.readout(x)
