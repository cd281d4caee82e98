"""RNN_TITO: a NodeRNN's sensor nodes into DynEdgeTITO (counterpart of
``graphnet_tpu/models/gnn/rnn_tito.py``).

The GRU turns each sensor's pulse series into one node (its summary
features and the GRU state, ``rnn_hidden_size + 5`` columns); the
DynTrans blocks of :class:`~graphnet_tpu_torch.models.gnn.
dynedge_kaggle_tito.DynEdgeTITO` then run on the sensor nodes: the kNN
(row 1, on x, y, z, t), the EdgeConv with max aggregation (row 2) and
the attention of ``n_head`` heads (rows 5a-c; GraphNeT's 256 wide, 16
heads of 16).
"""

from __future__ import annotations

from typing import Tuple

import torch

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.models.gnn.dynedge_kaggle_tito import DynEdgeTITO
from graphnet_tpu_torch.models.gnn.gnn import GNN
from graphnet_tpu_torch.models.rnn.node_rnn import NodeRNN
from graphnet_tpu_torch.utils.config import save_config


class RNNTITO(GNN):
    """Arguments and defaults are the JAX package's (GraphNeT's
    ``RNN_TITO``, a name the class registry also knows).  ``nb_inputs``
    is recorded and not read: the GRU reads ``time_series_columns``.
    ``rnn_dropout`` and ``deterministic`` reach the GRU only; the
    DynTrans blocks have no dropout, as in the JAX package."""

    @save_config
    def __init__(
        self,
        nb_inputs: int,
        time_series_columns: Tuple[int, ...],
        nb_neighbours: int = 8,
        rnn_layers: int = 2,
        rnn_hidden_size: int = 64,
        rnn_dropout: float = 0.5,
        features_subset: Tuple[int, ...] = (0, 1, 2, 3),
        dyntrans_layer_sizes: Tuple[Tuple[int, ...], ...] = (
            (256, 256),
            (256, 256),
            (256, 256),
            (256, 256),
        ),
        post_processing_layer_sizes: Tuple[int, ...] = (336, 256),
        readout_layer_sizes: Tuple[int, ...] = (256, 128),
        global_pooling_schemes: Tuple[str, ...] = ("max",),
        embedding_dim: int = 0,
        n_head: int = 16,
        use_global_features: bool = True,
        use_post_processing_layers: bool = True,
        deterministic: bool = True,
    ):
        super().__init__()
        self.nb_inputs = nb_inputs
        self.readout_layer_sizes = tuple(readout_layer_sizes)
        self.rnn = NodeRNN(
            nb_inputs=len(time_series_columns),
            hidden_size=rnn_hidden_size,
            num_layers=rnn_layers,
            time_series_columns=time_series_columns,
            nb_neighbours=nb_neighbours,
            features_subset=features_subset,
            dropout=rnn_dropout,
            embedding_dim=embedding_dim,
            deterministic=deterministic,
        )
        self.dynedge_tito = DynEdgeTITO(
            nb_inputs=rnn_hidden_size + 5,
            dyntrans_layer_sizes=dyntrans_layer_sizes,
            features_subset=features_subset,
            global_pooling_schemes=global_pooling_schemes,
            use_global_features=use_global_features,
            use_post_processing_layers=use_post_processing_layers,
            post_processing_layer_sizes=post_processing_layer_sizes,
            readout_layer_sizes=readout_layer_sizes,
            n_head=n_head,
            nb_neighbours=nb_neighbours,
        )

    @property
    def nb_outputs(self) -> int:
        return self.readout_layer_sizes[-1]

    def forward(self, batch: EventBatch) -> torch.Tensor:
        return self.dynedge_tito(self.rnn(batch))
