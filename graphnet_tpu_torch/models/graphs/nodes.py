"""Node definitions (counterpart of ``graphnet_tpu/models/graphs/nodes.py``):
host-side numpy transforms from one event's standardised ``[n, d]``
pulse array to its ``[m, d']`` node array.  Padding and bucketing happen
at collate time."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from graphnet_tpu_torch.models.graphs.utils import (
    cluster_summarize_with_percentiles,
    ice_transparency,
    identify_indices,
    lex_sort,
)
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


class PercentileClusters(NodeDefinition):
    """One node per cluster of pulses that share the ``cluster_on``
    columns (a sensor): its key, the ``percentiles`` of each other
    column over the cluster's pulses and, with ``add_counts``, log10 of
    its pulse count."""

    @save_config
    def __init__(
        self,
        cluster_on: List[str],
        percentiles: List[int],
        add_counts: bool = True,
        input_feature_names: Optional[List[str]] = None,
    ) -> None:
        self._cluster_on = cluster_on
        self._percentiles = percentiles
        self._add_counts = add_counts
        super().__init__(input_feature_names=input_feature_names)

    def _define_output_feature_names(
        self, input_feature_names: List[str]
    ) -> List[str]:
        cluster_idx, summ_idx, summ_names = identify_indices(
            input_feature_names, self._cluster_on
        )
        self._cluster_indices = cluster_idx
        self._summarization_indices = summ_idx
        names = list(self._cluster_on)
        for feature in summ_names:
            for pct in self._percentiles:
                names.append(f"{feature}_pct{pct}")
        if self._add_counts:
            names.append("counts")
        return names

    def _construct_nodes(self, x: np.ndarray) -> np.ndarray:
        return cluster_summarize_with_percentiles(
            x=np.asarray(x, np.float64),
            summarization_indices=self._summarization_indices,
            cluster_indices=self._cluster_indices,
            percentiles=self._percentiles,
            add_counts=self._add_counts,
        ).astype(np.float32)


class NodeAsDOMTimeSeries(NodeDefinition):
    """Per-sensor time series for :class:`~graphnet_tpu_torch.models.
    rnn.node_rnn.NodeRNN`: the pulses sorted by time, the charge column
    turned back from log10 to linear charge (a unit charge column
    inserted where the detector has none), the times made relative to
    the event's first, then the pulses grouped by sensor (``id_columns``,
    stable, so each sensor's series stays in time order), and a last
    column ``new_node_col`` that is 1 at the first pulse of each
    sensor."""

    @save_config
    def __init__(
        self,
        keys: List[str] = (
            "dom_x",
            "dom_y",
            "dom_z",
            "dom_time",
            "charge",
        ),
        id_columns: List[str] = ("dom_x", "dom_y", "dom_z"),
        time_column: str = "dom_time",
        charge_column: str = "charge",
        max_activations: Optional[int] = None,
    ) -> None:
        self._keys = list(keys)
        # before super().__init__: the output names it defines depend on
        # whether a charge column is inserted
        self._charge_index = (
            self._keys.index(charge_column)
            if charge_column in self._keys
            else None
        )
        super().__init__(input_feature_names=self._keys)
        self._id_columns = [self._keys.index(k) for k in id_columns]
        self._time_index = self._keys.index(time_column)
        self._max_activations = max_activations

    def _define_output_feature_names(
        self, input_feature_names: List[str]
    ) -> List[str]:
        names = list(input_feature_names)
        if self._charge_index is None:
            names.append("charge")
        return names + ["new_node_col"]

    def _construct_nodes(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if x.shape[0] == 0:
            extra = 2 if self._charge_index is None else 1
            return np.zeros((0, x.shape[1] + extra), np.float32)
        if self._charge_index is None:
            charge_index = x.shape[1]
            x = np.insert(x, charge_index, 0.0, axis=1)
        else:
            charge_index = self._charge_index
        x = x[x[:, self._time_index].argsort()]
        x[:, charge_index] = np.power(10.0, x[:, charge_index])
        x[:, self._time_index] -= x[:, self._time_index].min()
        x = lex_sort(x, self._id_columns)
        keys = x[:, self._id_columns]
        change = np.any(keys[1:] != keys[:-1], axis=1)
        new_node_col = np.zeros(x.shape[0])
        new_node_col[0] = 1
        new_node_col[1:][change] = 1
        return np.column_stack([x, new_node_col]).astype(np.float32)


class IceMixNodes(NodeDefinition):
    """The Kaggle IceMix nodes: the HLC flag flipped (the Kaggle data's
    ``auxiliary`` is 1 for a pulse that is not HLC), events longer than
    ``max_pulses`` subsampled with HLC pulses first, and the interpolated
    ice scattering and absorption lengths at each pulse's depth appended
    as two columns (``add_ice_properties``).

    The subsample is drawn from ``np.random.default_rng(seed)``, one
    generator for the object's life, exactly as the JAX package draws
    it: the same seed and the same events in the same order pick the
    same pulses in both packages.
    """

    @save_config
    def __init__(
        self,
        input_feature_names: Optional[List[str]] = None,
        max_pulses: int = 768,
        z_name: str = "dom_z",
        hlc_name: Optional[str] = "hlc",
        add_ice_properties: bool = True,
        ice_args: Optional[Dict[str, Optional[float]]] = None,
        seed: Optional[int] = None,
    ) -> None:
        if input_feature_names is None:
            input_feature_names = [
                "dom_x",
                "dom_y",
                "dom_z",
                "dom_time",
                "charge",
                "hlc",
                "rde",
            ]
        ice_args = ice_args or {"z_offset": None, "z_scaling": None}
        if add_ice_properties:
            if z_name not in input_feature_names:
                raise ValueError(
                    f"z name {z_name!r} not in {input_feature_names}"
                )
            self.all_features = list(input_feature_names) + [
                "scatt_lenght",
                "abs_lenght",
            ]
            self.f_scattering, self.f_absorption = ice_transparency(
                **ice_args
            )
        else:
            self.all_features = list(input_feature_names)
        if hlc_name is not None and hlc_name not in input_feature_names:
            hlc_name = None
        self.feature_indexes = {
            f: self.all_features.index(f) for f in input_feature_names
        }
        self.max_length = max_pulses
        self.z_name = z_name
        self.hlc_name = hlc_name
        self.add_ice_properties = add_ice_properties
        self._rng = np.random.default_rng(seed)
        super().__init__(input_feature_names=input_feature_names)

    def _define_output_feature_names(
        self, input_feature_names: List[str]
    ) -> List[str]:
        return self.all_features

    def _pulse_sampler(self, x: np.ndarray, n: int) -> np.ndarray:
        if n < self.max_length:
            return np.arange(n)
        ids = self._rng.permutation(n)
        if self.hlc_name is not None:
            hlc = x[:, self.feature_indexes[self.hlc_name]]
            # after the flip, hlc == 0 marks the HLC pulses, kept first
            ids_n = ids[hlc[ids] == 0][: self.max_length]
            ids_p = ids[hlc[ids] == 1][: self.max_length - len(ids_n)]
            return np.sort(np.concatenate([ids_n, ids_p]))
        return ids[: self.max_length]

    def _construct_nodes(self, x: np.ndarray) -> np.ndarray:
        x = np.array(x, np.float64, copy=True)
        n = x.shape[0]
        if self.hlc_name is not None:
            c = self.feature_indexes[self.hlc_name]
            x[:, c] = np.logical_not(x[:, c])
        ids = self._pulse_sampler(x, n)
        m = min(self.max_length, n)
        out = np.zeros((m, len(self.all_features)), np.float32)
        if self.add_ice_properties:
            z = x[ids, self.feature_indexes[self.z_name]]
            out[: len(ids), -2] = self.f_scattering(z)
            out[: len(ids), -1] = self.f_absorption(z)
            non_ice = self.all_features[:-2]
        else:
            non_ice = self.all_features
        for i, feature in enumerate(non_ice):
            out[:m, i] = x[ids, self.feature_indexes[feature]]
        return out
