"""Coarsening (counterpart of ``graphnet_tpu/models/coarsening.py``):
numpy maps of one :class:`~graphnet_tpu_torch.models.graphs.
graph_definition.Event` to a new Event whose nodes are clusters of its
pulses (DOMs, say) with reduced features.  They run on the host, inside
the data pipeline, before padding, as node definitions do."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from graphnet_tpu_torch.models.graphs.graph_definition import Event

_REDUCERS = {
    "avg": np.mean,
    "min": np.min,
    "max": np.max,
    "sum": np.sum,
}


def _segment_reduce(
    values: np.ndarray, cluster: np.ndarray, n_clusters: int, fn
) -> np.ndarray:
    out = np.zeros((n_clusters,) + values.shape[1:], values.dtype)
    for c in range(n_clusters):
        sel = values[cluster == c]
        if len(sel):
            out[c] = fn(sel, axis=0)
    return out


class Coarsening:
    """Base coarsening: cluster the nodes, reduce the features of each
    cluster by ``reduce`` (``avg``, ``min``, ``max`` or ``sum``); with
    ``transfer_attributes`` the event's labels carry over and its node
    labels are reduced alike."""

    def __init__(self, reduce: str = "avg", transfer_attributes: bool = True):
        if reduce not in _REDUCERS:
            raise ValueError(f"unknown reduce {reduce!r}")
        self._reduce = _REDUCERS[reduce]
        self._transfer_attributes = transfer_attributes

    def _perform_clustering(self, event: Event) -> np.ndarray:
        raise NotImplementedError

    def _additional_features(
        self, cluster: np.ndarray, event: Event
    ) -> Optional[np.ndarray]:
        return None

    def __call__(self, event: Event) -> Event:
        cluster = self._perform_clustering(event)
        # compact cluster ids, in sorted order of the clustering's ids
        _, inverse = np.unique(cluster, return_inverse=True)
        n = int(inverse.max()) + 1 if len(inverse) else 0
        x = _segment_reduce(event.x, inverse, n, self._reduce)
        extra = self._additional_features(inverse, event)
        if extra is not None:
            x = np.concatenate([x, extra], axis=1)
        new_event = Event(
            x=x.astype(np.float32),
            features=list(event.features),
            labels=dict(event.labels) if self._transfer_attributes else {},
            node_labels={},
        )
        if self._transfer_attributes:
            for k, v in event.node_labels.items():
                new_event.node_labels[k] = _segment_reduce(
                    np.asarray(v), inverse, n, self._reduce)
        return new_event


class AttributeCoarsening(Coarsening):
    """Clusters of the pulses that share the values of ``attributes``."""

    def __init__(
        self,
        attributes: List[str],
        reduce: str = "avg",
        transfer_attributes: bool = True,
    ):
        super().__init__(reduce, transfer_attributes)
        self._attributes = attributes

    def _perform_clustering(self, event: Event) -> np.ndarray:
        cols = [event.features.index(a) for a in self._attributes]
        _, inverse = np.unique(event.x[:, cols], axis=0, return_inverse=True)
        return inverse


class DOMCoarsening(AttributeCoarsening):
    """Clusters of the pulses of one DOM (``keys``: its position, ``rde``
    and ``pmt_area`` by default)."""

    def __init__(
        self,
        reduce: str = "avg",
        transfer_attributes: bool = True,
        keys: Optional[List[str]] = None,
    ):
        keys = keys or ["dom_x", "dom_y", "dom_z", "rde", "pmt_area"]
        super().__init__(keys, reduce, transfer_attributes)


class CustomDOMCoarsening(DOMCoarsening):
    """DOM clusters with seven features more: the min, max and standard
    deviation of ``dom_time`` and of ``charge``, and the pulse count."""

    def _additional_features(
        self, cluster: np.ndarray, event: Event
    ) -> np.ndarray:
        ix_time = event.features.index("dom_time")
        ix_charge = event.features.index("charge")
        n = int(cluster.max()) + 1 if len(cluster) else 0
        time = event.x[:, ix_time]
        charge = event.x[:, ix_charge]
        cols = [
            _segment_reduce(time, cluster, n, np.min),
            _segment_reduce(time, cluster, n, np.max),
            _segment_reduce(time, cluster, n, np.std),
            _segment_reduce(charge, cluster, n, np.min),
            _segment_reduce(charge, cluster, n, np.max),
            _segment_reduce(charge, cluster, n, np.std),
            np.bincount(cluster, minlength=n).astype(np.float32),
        ]
        return np.stack(cols, axis=1)


class DOMAndTimeWindowCoarsening(Coarsening):
    """DOM clusters split in time: DBSCAN (scikit-learn, imported in the
    call) with ``eps = time_window`` over the pulse times, with the DOM
    index scaled so that no cluster spans two DOMs."""

    def __init__(
        self,
        time_window: float,
        reduce: str = "avg",
        transfer_attributes: bool = True,
        keys: Optional[List[str]] = None,
        time_key: str = "dom_time",
    ):
        super().__init__(reduce, transfer_attributes)
        self._time_window = time_window
        self._keys = keys or ["dom_x", "dom_y", "dom_z", "rde", "pmt_area"]
        self._time_key = time_key

    def _perform_clustering(self, event: Event) -> np.ndarray:
        from sklearn.cluster import DBSCAN

        cols = [event.features.index(a) for a in self._keys]
        _, dom_index = np.unique(event.x[:, cols], axis=0, return_inverse=True)
        hit_times = event.x[:, event.features.index(self._time_key)]
        pts = np.stack(
            [hit_times, dom_index * self._time_window * 10.0], axis=1)
        return DBSCAN(self._time_window, min_samples=1).fit_predict(pts)
