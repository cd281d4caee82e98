"""The host-side per-event pipeline (counterpart of
``graphnet_tpu/models/graphs/graph_definition.py``).

Per event: validate, optionally add the inactive sensors, mask sensors
or strings, perturb with a seeded Gaussian, standardise with the
detector, build the nodes, optionally sort by a feature, and attach
truth, labels and weights.  The result is an :class:`Event` (numpy
arrays and dicts); padding into an ``EventBatch`` happens at collate
time, and the ``edge_definition`` rule is evaluated on the device for
the whole padded batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from graphnet_tpu_torch.models.detector.detector import Detector
from graphnet_tpu_torch.models.graphs.edges import EdgeDefinition
from graphnet_tpu_torch.models.graphs.nodes import NodeDefinition, NodesAsPulses
from graphnet_tpu_torch.utils.config import save_config


@dataclass
class Event:
    """One processed event: node array + truth labels."""

    x: np.ndarray  # [n_nodes, d] float32
    features: List[str]
    labels: Dict[str, Any] = field(default_factory=dict)
    node_labels: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def n_pulses(self) -> int:
        return self.x.shape[0]


class GraphDefinition:
    """Detector + NodeDefinition + EdgeDefinition pipeline; arguments and
    defaults are the JAX package's."""

    @save_config
    def __init__(
        self,
        detector: Detector,
        node_definition: Optional[NodeDefinition] = None,
        edge_definition: Optional[EdgeDefinition] = None,
        input_feature_names: Optional[List[str]] = None,
        perturbation_dict: Optional[Dict[str, float]] = None,
        seed: Optional[Union[int, np.random.Generator]] = None,
        add_inactive_sensors: bool = False,
        sensor_mask: Optional[List[int]] = None,
        string_mask: Optional[List[int]] = None,
        sort_by: Optional[str] = None,
        repeat_labels: bool = False,
    ) -> None:
        self._detector = detector
        self._node_definition = node_definition or NodesAsPulses()
        self.edge_definition = edge_definition
        self._perturbation_dict = perturbation_dict
        self._sensor_mask = sensor_mask
        self._string_mask = string_mask
        self._add_inactive_sensors = add_inactive_sensors
        self._repeat_labels = repeat_labels

        if sensor_mask is not None and string_mask is not None:
            raise ValueError(
                "Specify only one of `sensor_mask` and `string_mask`."
            )
        if sensor_mask is None and string_mask is not None:
            self._sensor_mask = self._convert_string_to_sensor_mask()

        if input_feature_names is None:
            input_feature_names = list(detector.feature_map().keys())
        self._input_feature_names = list(input_feature_names)

        self._node_definition.set_output_feature_names(
            self._input_feature_names
        )
        self.output_feature_names = (
            self._node_definition.output_feature_names
        )

        self._sort_by: Optional[int] = None
        if sort_by is not None:
            if sort_by not in self.output_feature_names:
                raise ValueError(
                    f"{sort_by} not in node features "
                    f"{self.output_feature_names}."
                )
            self._sort_by = self.output_feature_names.index(sort_by)

        self.nb_inputs = len(self._input_feature_names)
        self.nb_outputs = self._node_definition.nb_outputs

        if perturbation_dict is not None:
            self._perturbation_cols = [
                self._input_feature_names.index(k)
                for k in perturbation_dict
            ]
        if isinstance(seed, np.random.Generator):
            self.rng = seed
        else:
            self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------
    def _convert_string_to_sensor_mask(self) -> List[int]:
        """String mask -> sensor-id mask via the geometry table."""
        g = self._detector.geometry_table
        idx = g[self._detector.string_id_column].isin(self._string_mask)
        return np.asarray(
            g.loc[idx, self._detector.sensor_id_column]
        ).tolist()

    def _geometry_table_lookup(
        self, input_features: np.ndarray, input_feature_names: List[str]
    ):
        cols = [
            input_feature_names.index(f)
            for f in self._detector.sensor_position_names
        ]
        idx = [*zip(*[tuple(input_features[:, c]) for c in cols])]
        return self._detector.geometry_table.loc[idx, :].index

    def _attach_inactive_sensors(
        self, input_features: np.ndarray, input_feature_names: List[str]
    ) -> np.ndarray:
        """Append the geometry table's sensors absent from the event, with
        their table features (zero pulse features)."""
        lookup = self._geometry_table_lookup(
            input_features, input_feature_names
        )
        g = self._detector.geometry_table
        inactive_mask = ~g.index.isin(lookup)
        inactive = (
            g.reset_index(drop=True)
            .loc[inactive_mask, input_feature_names]
            .to_numpy()
        )
        return np.concatenate([input_features, inactive], axis=0)

    def _mask_sensors(
        self, input_features: np.ndarray, input_feature_names: List[str]
    ) -> np.ndarray:
        lookup = self._geometry_table_lookup(
            input_features, input_feature_names
        )
        g = self._detector.geometry_table
        keep = ~g.loc[lookup, self._detector.sensor_id_column].isin(
            self._sensor_mask
        )
        return input_features[np.asarray(keep), :]

    def _perturb_input(self, input_features: np.ndarray) -> np.ndarray:
        if self._perturbation_dict:
            stds = np.array(
                list(self._perturbation_dict.values()), dtype=float
            )
            input_features = np.array(input_features, copy=True)
            input_features[:, self._perturbation_cols] = self.rng.normal(
                loc=input_features[:, self._perturbation_cols], scale=stds
            )
        return input_features

    # ------------------------------------------------------------------
    def __call__(
        self,
        input_features: np.ndarray,
        input_feature_names: List[str],
        truth_dicts: Optional[List[Dict[str, Any]]] = None,
        custom_label_functions: Optional[Dict[str, Callable]] = None,
        loss_weight_column: Optional[str] = None,
        loss_weight: Optional[float] = None,
        loss_weight_default_value: Optional[float] = None,
        data_path: Optional[str] = None,
    ) -> Event:
        """Build one :class:`Event`."""
        input_features = np.asarray(input_features, dtype=np.float64)
        if input_features.ndim != 2 or input_features.shape[1] != len(
            input_feature_names
        ):
            raise ValueError(
                f"input_features must be [n, {len(input_feature_names)}]; "
                f"got {input_features.shape}"
            )
        if list(input_feature_names) != self._input_feature_names:
            raise ValueError(
                f"Expected features {self._input_feature_names}, got "
                f"{input_feature_names}"
            )

        if self._add_inactive_sensors:
            input_features = self._attach_inactive_sensors(
                input_features, input_feature_names
            )
        if self._sensor_mask is not None:
            input_features = self._mask_sensors(
                input_features, input_feature_names
            )
        input_features = self._perturb_input(input_features)

        standardized = self._detector(
            input_features.astype(np.float32), list(input_feature_names)
        )
        x = self._node_definition(standardized)
        if self._sort_by is not None:
            x = x[np.argsort(x[:, self._sort_by], kind="stable")]

        event = Event(
            x=np.asarray(x, np.float32),
            features=list(self.output_feature_names),
        )
        event.labels["n_pulses"] = np.int32(input_features.shape[0])
        if data_path is not None:
            event.labels["dataset_path"] = data_path

        if loss_weight is not None and loss_weight_column is not None:
            if loss_weight < 0:
                if loss_weight_default_value is None:
                    raise ValueError(
                        f"Event missing {loss_weight_column} and no "
                        "loss_weight_default_value given."
                    )
                loss_weight = loss_weight_default_value
            event.labels[loss_weight_column] = np.float32(loss_weight)

        if truth_dicts is not None:
            for truth_dict in truth_dicts:
                for key, value in truth_dict.items():
                    if isinstance(value, str) or value is None:
                        continue
                    event.labels[key] = np.asarray(value)
                    self._maybe_repeat_to_nodes(event, key)

        if custom_label_functions is not None:
            for key, fn in custom_label_functions.items():
                event.labels[key] = np.asarray(fn(event))
                self._maybe_repeat_to_nodes(event, key)

        return event

    @property
    def supports_batched(self) -> bool:
        """True when the per-event transform is a pure row-wise function
        (no inactive sensors, masking, perturbation, node-repeated labels,
        or node definition other than one node per pulse), so
        :meth:`build_x_batched` can run it once on a whole batch."""
        return (
            not self._add_inactive_sensors
            and self._sensor_mask is None
            and not self._perturbation_dict
            and not self._repeat_labels
            and type(self._node_definition) is NodesAsPulses
        )

    def build_x_batched(
        self, features_list: List[np.ndarray]
    ) -> Optional[List[np.ndarray]]:
        """One detector pass over the concatenation of every event's
        pulses, split back per event (plus the per-event sort): the same
        node arrays as :meth:`__call__` per event where
        :attr:`supports_batched` holds; None otherwise."""
        if not self.supports_batched or not features_list:
            return None
        counts = [int(f.shape[0]) for f in features_list]
        concat = np.concatenate(
            [
                np.asarray(f, np.float64).reshape(
                    -1, len(self._input_feature_names)
                )
                for f in features_list
            ],
            axis=0,
        ).astype(np.float32)
        standardized = self._detector(
            concat, list(self._input_feature_names)
        )
        xs = np.split(
            np.asarray(standardized, np.float32),
            np.cumsum(counts)[:-1],
        )
        if self._sort_by is not None:
            xs = [
                x[np.argsort(x[:, self._sort_by], kind="stable")]
                for x in xs
            ]
        return xs

    def _maybe_repeat_to_nodes(self, event: Event, key: str) -> None:
        """``repeat_labels=True``: a numeric scalar label is also repeated
        to every node, into ``event.node_labels``."""
        if not self._repeat_labels:
            return
        v = np.asarray(event.labels[key])
        if v.ndim == 0 and v.dtype.kind in "bifu":
            event.node_labels[key] = np.repeat(
                np.float32(v), event.x.shape[0]
            )
