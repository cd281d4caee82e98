"""Node definitions (counterpart of ``graphnet_tpu/models/graphs/nodes.py``;
:class:`NodesAsPulses` so far): host-side numpy transforms from one
event's standardised ``[n, d]`` pulse array to its ``[m, d']`` node
array.  Padding and bucketing happen at collate time."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from graphnet_tpu_torch.utils.config import save_config


class NodeDefinition:
    """Base node definition."""

    @save_config
    def __init__(
        self, input_feature_names: Optional[List[str]] = None
    ) -> None:
        self._output_feature_names: Optional[List[str]] = None
        if input_feature_names is not None:
            self.set_output_feature_names(input_feature_names)

    def set_output_feature_names(
        self, input_feature_names: List[str]
    ) -> None:
        self._output_feature_names = self._define_output_feature_names(
            input_feature_names
        )

    @property
    def output_feature_names(self) -> List[str]:
        if self._output_feature_names is None:
            raise ValueError(
                f"{type(self).__name__} needs input_feature_names before use"
            )
        return self._output_feature_names

    @property
    def nb_outputs(self) -> int:
        return len(self.output_feature_names)

    def _define_output_feature_names(
        self, input_feature_names: List[str]
    ) -> List[str]:
        raise NotImplementedError

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if self._output_feature_names is None:
            raise ValueError(
                f"{type(self).__name__} needs input_feature_names before use"
            )
        return self._construct_nodes(x)

    def _construct_nodes(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class NodesAsPulses(NodeDefinition):
    """One node per pulse."""

    def _define_output_feature_names(
        self, input_feature_names: List[str]
    ) -> List[str]:
        return list(input_feature_names)

    def _construct_nodes(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float32)
