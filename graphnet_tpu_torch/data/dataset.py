"""Dataset base class (counterpart of ``graphnet_tpu/data/dataset.py``).

A Dataset maps a sequential index to an :class:`~graphnet_tpu_torch.
models.graphs.graph_definition.Event` by querying a storage backend for
the pulse rows and the truth and running the GraphDefinition's host
pipeline.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from graphnet_tpu_torch.constants import GRAPHNET_ROOT_DIR
from graphnet_tpu_torch.models.graphs.graph_definition import (
    Event,
    GraphDefinition,
)
from graphnet_tpu_torch.utils.config import save_config

_CLASS_LABELS = ("muon", "muon_stopped", "noise", "neutrino", "v_e", "v_u",
                 "v_t", "track", "dbang", "corsika")


class ColumnMissingException(Exception):
    """A requested column is missing from the input table."""


class Dataset:
    """Abstract dataset over an intermediate-format file.

    Subclasses implement ``_init``, ``_get_all_indices``,
    ``_get_event_index`` and ``query_table``.  Arguments and defaults are
    the JAX package's.  ``selection`` is None, a list of event indices or
    a selection string (:class:`~graphnet_tpu_torch.data.
    string_selection_resolver.StringSelectionResolver`); named selections
    (a dict) belong in a dataset config (``utils.config.load_dataset``).
    ``labels`` maps a key to a function of the Event, such as the
    ``Label`` objects of :mod:`graphnet_tpu_torch.training.labels`
    (whose ``batched`` form the DataLoader's batched route calls).
    """

    @save_config
    def __init__(
        self,
        path: Union[str, List[str]],
        graph_definition: GraphDefinition,
        pulsemaps: Union[str, List[str]],
        features: List[str],
        truth: List[str],
        *,
        node_truth: Optional[List[str]] = None,
        index_column: str = "event_no",
        truth_table: str = "truth",
        node_truth_table: Optional[str] = None,
        string_selection: Optional[List[int]] = None,
        selection: Optional[Union[str, List[int]]] = None,
        loss_weight_table: Optional[str] = None,
        loss_weight_column: Optional[str] = None,
        loss_weight_default_value: Optional[float] = None,
        seed: Optional[int] = None,
        labels: Optional[Dict[str, Callable]] = None,
    ):
        if isinstance(selection, dict):
            raise TypeError(
                "dict selections build several datasets: put the dict in a "
                "dataset-config YAML and use "
                "graphnet_tpu_torch.utils.config.load_dataset()"
            )
        if isinstance(pulsemaps, str):
            pulsemaps = [pulsemaps]

        # the `$GRAPHNET` path macro: the repository root
        def expand(p):
            return p.replace("$GRAPHNET", GRAPHNET_ROOT_DIR)

        path = (
            expand(path)
            if isinstance(path, str)
            else [expand(p) for p in path]
        )
        self._path = path
        self._selection: Optional[str] = None
        self._pulsemaps = pulsemaps
        self._features = list(features)
        self._truth = [index_column] + [
            t for t in truth if t != index_column
        ]
        self._index_column = index_column
        self._truth_table = truth_table
        self._loss_weight_default_value = loss_weight_default_value
        self._graph_definition = graph_definition
        self._node_truth = node_truth
        self._node_truth_table = node_truth_table
        self._string_selection = string_selection
        if string_selection:
            col = graph_definition._detector.string_index_name
            self._selection = f"{col} in {tuple(string_selection)}"
        self._loss_weight_column = loss_weight_column
        self._loss_weight_table = loss_weight_table
        if (loss_weight_table is None) != (loss_weight_column is None):
            raise ValueError(
                "Specify both or neither of loss_weight_table and "
                "loss_weight_column"
            )
        self._seed = seed
        self._label_fns: Dict[str, Callable[[Event], Any]] = {}
        if labels is not None:
            for key, fn in labels.items():
                self.add_label(fn, key)

        self._missing_variables: Dict[str, List[str]] = {}
        self._init()
        if selection is None:
            self._indices = self._get_all_indices()
        elif isinstance(selection, str):
            from graphnet_tpu_torch.data.string_selection_resolver import (
                StringSelectionResolver,
            )

            self._indices = StringSelectionResolver(
                self, index_column=index_column, seed=seed
            ).resolve(selection)
        else:
            self._indices = list(selection)
        self._post_init()

    # --- subclass hooks ---------------------------------------------------
    def _init(self) -> None:
        pass

    def _post_init(self) -> None:
        pass

    def _get_all_indices(self) -> List[int]:
        raise NotImplementedError

    def _get_event_index(self, sequential_index: Optional[int]) -> int:
        raise NotImplementedError

    def query_table(
        self,
        table: str,
        columns: Union[List[str], str],
        sequential_index: Optional[int] = None,
        selection: Optional[str] = None,
    ) -> np.ndarray:
        raise NotImplementedError

    # --- public -----------------------------------------------------------
    @property
    def path(self) -> Union[str, List[str]]:
        return self._path

    @property
    def truth_table(self) -> str:
        return self._truth_table

    def add_label(
        self, fn: Callable[[Event], Any], key: Optional[str] = None
    ) -> None:
        """Register a custom label: ``fn(event)`` under ``key`` (or under
        ``fn.key``)."""
        key = getattr(fn, "key", None) if key is None else key
        if not isinstance(key, str):
            raise ValueError("Specify a key for the custom label.")
        if key in self._label_fns:
            raise ValueError(f"Label {key} already defined.")
        self._label_fns[key] = fn

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, sequential_index: int) -> Event:
        if not (0 <= sequential_index < len(self)):
            raise IndexError(
                f"Index {sequential_index} not in range [0, {len(self)-1}]"
            )
        features, truth, node_truth, loss_weight = self._query(
            sequential_index
        )
        return self._create_graph(features, truth, node_truth, loss_weight)

    def get_events(self, sequential_indices: List[int]) -> List[Event]:
        """Several events; backends may override with one batched storage
        query per table."""
        return [self[i] for i in sequential_indices]

    # --- internals ---------------------------------------------------------
    def _query(
        self, sequential_index: int
    ) -> Tuple[
        np.ndarray, np.ndarray, Optional[np.ndarray], Optional[float]
    ]:
        """Pulse rows, truth row, node truth and loss weight of one event."""
        features = [
            self.query_table(
                pulsemap, self._features, sequential_index, self._selection
            )
            for pulsemap in self._pulsemaps
        ]
        features_arr = (
            np.concatenate(features, axis=0)
            if features
            else np.zeros((0, len(self._features)))
        )
        truth = self.query_table(
            self._truth_table, self._truth, sequential_index
        )
        node_truth = None
        if self._node_truth:
            if self._node_truth_table is None:
                raise ValueError("node_truth needs a node_truth_table")
            node_truth = self.query_table(
                self._node_truth_table,
                self._node_truth,
                sequential_index,
                self._selection,
            )
        loss_weight = None
        if self._loss_weight_column is not None:
            res = self.query_table(
                self._loss_weight_table,
                self._loss_weight_column,
                sequential_index,
            )
            loss_weight = float(res[0][0]) if len(res) else -1.0
        return features_arr, truth, node_truth, loss_weight

    def _create_graph(
        self,
        features: np.ndarray,
        truth: np.ndarray,
        node_truth: Optional[np.ndarray] = None,
        loss_weight: Optional[float] = None,
    ) -> Event:
        """Run the GraphDefinition with the truth dicts."""
        truth = np.asarray(truth)
        if truth.ndim == 1:
            truth = truth.reshape(1, -1)
        truth_dict = {
            key: truth[0, i] for i, key in enumerate(self._truth)
        }
        labels_dict = self._get_labels(truth_dict)
        truth_dicts = [labels_dict, truth_dict]

        event = self._graph_definition(
            input_features=np.asarray(features, np.float64).reshape(
                -1, len(self._features)
            ),
            input_feature_names=self._features,
            truth_dicts=truth_dicts,
            custom_label_functions=None,
            loss_weight_column=self._loss_weight_column,
            loss_weight=loss_weight,
            loss_weight_default_value=self._loss_weight_default_value,
        )
        if node_truth is not None and self._node_truth:
            nt = np.asarray(node_truth)
            for i, key in enumerate(self._node_truth):
                event.node_labels[key] = nt[:, i].astype(np.float32)
        # custom labels run on the event (so they can see truth labels)
        for key, fn in self._label_fns.items():
            event.labels[key] = np.asarray(fn(event))
        return event

    def _get_labels(self, truth_dict: Dict[str, Any]) -> Dict[str, Any]:
        """Classification labels derived from ``pid``; -1 without it."""
        if "pid" in truth_dict:
            abs_pid = abs(truth_dict["pid"])
            return {
                self._index_column: truth_dict[self._index_column],
                "muon": int(abs_pid == 13),
                "muon_stopped": int(
                    truth_dict.get("stopped_muon") == 1
                ),
                "neutrino": int((abs_pid != 13) & (abs_pid != 1)),
                "v_e": int(abs_pid == 12),
                "v_u": int(abs_pid == 14),
                "v_t": int(abs_pid == 16),
                "track": int(
                    (abs_pid == 14)
                    & (truth_dict.get("interaction_type") == 1)
                ),
                "dbang": self._get_dbang_label(truth_dict),
                "corsika": int(abs_pid > 20),
            }
        return {
            self._index_column: truth_dict[self._index_column],
            **{k: -1 for k in _CLASS_LABELS},
        }

    def _get_dbang_label(self, truth_dict: Dict[str, Any]) -> int:
        try:
            return int(truth_dict["dbang_decay_length"] > -1)
        except KeyError:
            return -1

    def _get_labels_batched(
        self, truth_cols: Dict[str, np.ndarray], n_events: int
    ) -> Dict[str, np.ndarray]:
        """:meth:`_get_labels` for a whole batch from ``[B]`` truth
        columns, with the same -1 fallbacks."""
        out: Dict[str, np.ndarray] = {}
        if "pid" not in truth_cols:
            for k in _CLASS_LABELS:
                out[k] = np.full(n_events, -1, np.int32)
            return out
        abs_pid = np.abs(truth_cols["pid"])
        stopped = truth_cols.get("stopped_muon")
        itype = truth_cols.get("interaction_type")
        dbang = truth_cols.get("dbang_decay_length")

        def i32(a):
            return np.asarray(a, np.int32)

        out["muon"] = i32(abs_pid == 13)
        out["muon_stopped"] = (
            i32(stopped == 1)
            if stopped is not None
            else np.zeros(n_events, np.int32)
        )
        out["neutrino"] = i32((abs_pid != 13) & (abs_pid != 1))
        out["v_e"] = i32(abs_pid == 12)
        out["v_u"] = i32(abs_pid == 14)
        out["v_t"] = i32(abs_pid == 16)
        out["track"] = (
            i32((abs_pid == 14) & (itype == 1))
            if itype is not None
            else np.zeros(n_events, np.int32)
        )
        out["dbang"] = (
            i32(dbang > -1)
            if dbang is not None
            else np.full(n_events, -1, np.int32)
        )
        out["corsika"] = i32(abs_pid > 20)
        return out


class EnsembleDataset:
    """Concatenation of datasets."""

    def __init__(self, datasets: List[Dataset]):
        self._datasets = list(datasets)
        self._cum = np.cumsum([len(d) for d in self._datasets])

    def __len__(self) -> int:
        return int(self._cum[-1]) if len(self._cum) else 0

    def __getitem__(self, index: int) -> Event:
        if index < 0 or index >= len(self):
            raise IndexError(index)
        d = int(np.searchsorted(self._cum, index, side="right"))
        prev = 0 if d == 0 else int(self._cum[d - 1])
        return self._datasets[d][index - prev]
