"""Graph construction: detectors feed node and edge definitions
(counterpart of ``graphnet_tpu/models/graphs``)."""

from graphnet_tpu_torch.models.graphs.edges import (
    EdgeDefinition,
    EuclideanEdges,
    KNNEdges,
    MinkowskiKNNEdges,
    RadialEdges,
)
from graphnet_tpu_torch.models.graphs.graph_definition import (
    Event,
    GraphDefinition,
)
from graphnet_tpu_torch.models.graphs.graphs import EdgelessGraph, KNNGraph
from graphnet_tpu_torch.models.graphs.nodes import (
    IceMixNodes,
    NodeDefinition,
    NodesAsPulses,
)
