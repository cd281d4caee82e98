"""Pre-configured graph definitions (counterpart of
``graphnet_tpu/models/graphs/graphs.py``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from graphnet_tpu_torch.models.detector.detector import Detector
from graphnet_tpu_torch.models.graphs.edges import KNNEdges
from graphnet_tpu_torch.models.graphs.graph_definition import GraphDefinition
from graphnet_tpu_torch.models.graphs.nodes import NodeDefinition
from graphnet_tpu_torch.utils.config import save_config


class KNNGraph(GraphDefinition):
    """kNN (k=8) graph on columns (0, 1, 2) with one node per pulse."""

    @save_config
    def __init__(
        self,
        detector: Detector,
        node_definition: Optional[NodeDefinition] = None,
        input_feature_names: Optional[List[str]] = None,
        perturbation_dict: Optional[Dict[str, float]] = None,
        seed: Optional[Union[int, np.random.Generator]] = None,
        nb_nearest_neighbours: int = 8,
        columns: tuple = (0, 1, 2),
        **kwargs,
    ) -> None:
        super().__init__(
            detector=detector,
            node_definition=node_definition,
            edge_definition=KNNEdges(
                nb_nearest_neighbours=nb_nearest_neighbours,
                columns=tuple(columns),
            ),
            input_feature_names=input_feature_names,
            perturbation_dict=perturbation_dict,
            seed=seed,
            **kwargs,
        )


class EdgelessGraph(GraphDefinition):
    """Node set without edges, for the transformer backbones."""

    def __init__(
        self,
        detector: Detector,
        node_definition: Optional[NodeDefinition] = None,
        input_feature_names: Optional[List[str]] = None,
        perturbation_dict: Optional[Dict[str, float]] = None,
        seed: Optional[Union[int, np.random.Generator]] = None,
        **kwargs,
    ) -> None:
        super().__init__(
            detector=detector,
            node_definition=node_definition,
            edge_definition=None,
            input_feature_names=input_feature_names,
            perturbation_dict=perturbation_dict,
            seed=seed,
            **kwargs,
        )
