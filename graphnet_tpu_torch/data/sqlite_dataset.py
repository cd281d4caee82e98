"""SQLite-backed dataset (counterpart of
``graphnet_tpu/data/sqlite_dataset.py``).

Connections are per thread (``sqlite3`` connections are bound to the
thread that opened them), so ``DataLoader(num_workers=N)``'s pool
threads each open their own, and they are closed after set-up so that
a forked worker opens its own too.  The batched fetch runs its queries
through the native fetch (``graphnet_tpu_torch/native.py``, one native
read-only handle per thread, GIL released) and takes Python's
``sqlite3`` where that is unavailable (several databases, no compiler)
or a cell is not numeric.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from graphnet_tpu_torch.data.dataset import ColumnMissingException, Dataset
from graphnet_tpu_torch.models.graphs.graph_definition import Event
from graphnet_tpu_torch.native import sqlite_close, sqlite_fetch_f64, sqlite_open


class _NativeHandle:
    """A thread's native SQLite handle, closed when that thread's storage
    drops it (a loader thread that ends) or by ``close``."""

    def __init__(self, value: int):
        self.value = value

    def close(self) -> None:
        sqlite_close(self.value)
        self.value = None

    def __del__(self):
        self.close()


class SQLiteDataset(Dataset):
    """Dataset reading events from one or more SQLite databases."""

    def _init(self) -> None:
        if isinstance(self._path, list):
            self._database_list: Optional[List[str]] = self._path
        else:
            self._database_list = None
            if not self._path.endswith(".db"):
                raise ValueError(f"Unsupported file format: {self._path}")

    # -- per-thread connection state ------------------------------------
    @property
    def _tls(self) -> threading.local:
        tls = self.__dict__.get("_tls_store")
        if tls is None:
            tls = threading.local()
            self.__dict__["_tls_store"] = tls
        return tls

    @property
    def _conn(self) -> Optional[sqlite3.Connection]:
        return getattr(self._tls, "conn", None)

    @_conn.setter
    def _conn(self, value) -> None:
        self._tls.conn = value

    def __getstate__(self):
        # thread-locals (and their connections) cannot cross a process
        # boundary; the worker reopens lazily
        state = dict(self.__dict__)
        state.pop("_tls_store", None)
        return state

    def _native_handle(self) -> Optional[int]:
        """The calling thread's native SQLite handle for the batched
        fetch; None where it is unavailable (several databases, no
        compiler or ``libsqlite3``)."""
        tls = self._tls
        h = getattr(tls, "native_handle", None)
        if h is None:
            opened = (sqlite_open(self._path)
                      if self._database_list is None else None)
            h = tls.native_handle = _NativeHandle(opened) if opened else False
        return h.value if h else None

    def _post_init(self) -> None:
        self._remove_missing_columns()
        self._close_connection()

    def _remove_missing_columns(self) -> None:
        """Drop the requested feature and truth columns the file lacks."""
        if len(self) == 0:
            return
        missing_features = set(self._features)
        for pulsemap in self._pulsemaps:
            missing = set()
            for col in list(self._features):
                try:
                    self.query_table(pulsemap, [col], 0)
                except ColumnMissingException:
                    missing.add(col)
            missing_features &= missing
        for col in missing_features:
            self._features.remove(col)
        for col in list(self._truth):
            try:
                self.query_table(self._truth_table, [col], 0)
            except ColumnMissingException:
                self._truth.remove(col)

    def query_table(
        self,
        table: str,
        columns: Union[List[str], str],
        sequential_index: Optional[int] = None,
        selection: Optional[str] = None,
    ) -> np.ndarray:
        if isinstance(columns, list):
            columns = ", ".join(columns)
        if not selection:
            selection = "1=1"
        index = self._get_event_index(sequential_index)
        self._establish_connection(
            sequential_index if sequential_index is not None else 0
        )
        if sequential_index is None:
            combined = selection
        else:
            combined = f"{self._index_column} = {index} and {selection}"
        try:
            result = self._conn.execute(
                f"SELECT {columns} FROM {table} WHERE {combined}"
            ).fetchall()
        except sqlite3.OperationalError as e:
            if "no such column" in str(e):
                raise ColumnMissingException(str(e)) from e
            raise
        return np.asarray(result)

    def _get_all_indices(self) -> List[int]:
        self._establish_connection(0)
        rows = self._conn.execute(
            f"SELECT {self._index_column} FROM {self._truth_table}"
        ).fetchall()
        self._close_connection()
        return [r[0] for r in rows]

    def _get_event_index(self, sequential_index: Optional[int]) -> int:
        if sequential_index is None:
            return 0
        idx = self._indices[sequential_index]
        if self._database_list is not None and isinstance(
            idx, (list, tuple)
        ):
            return int(idx[0])
        return int(idx)

    def _establish_connection(self, i: int) -> None:
        tls = self._tls
        if self._database_list is None:
            if self._conn is None:
                self._conn = sqlite3.connect(self._path)
            return
        idx = self._indices[i]
        if not isinstance(idx, (list, tuple)):
            raise ValueError(
                "multi-database selections must be (event_no, db_index) pairs"
            )
        if not getattr(tls, "all_established", False):
            tls.all_connections = [
                sqlite3.connect(db) for db in self._database_list
            ]
            tls.all_established = True
            tls.current_database = None
        if self._conn is None or idx[1] != tls.current_database:
            self._conn = tls.all_connections[idx[1]]
            tls.current_database = idx[1]

    def event_lengths(self) -> List[int]:
        """Pulse count per event (for length-matched batching), from one
        GROUP BY query per pulsemap."""
        if self._database_list is not None:
            return [
                sum(
                    len(self.query_table(pm, [self._index_column], i))
                    for pm in self._pulsemaps
                )
                for i in range(len(self))
            ]
        self._establish_connection(0)
        counts: Dict[int, int] = {}
        for pm in self._pulsemaps:
            rows = self._conn.execute(
                f"SELECT {self._index_column}, COUNT(*) FROM {pm} "
                f"GROUP BY {self._index_column}"
            ).fetchall()
            for event_no, n in rows:
                counts[event_no] = counts.get(event_no, 0) + n
        self._close_connection()
        return [counts.get(int(i), 0) for i in self._indices]

    def _close_connection(self) -> None:
        """Close the calling thread's connections."""
        tls = self._tls
        h = getattr(tls, "native_handle", None)
        if h:
            h.close()
            tls.native_handle = None
        if self._conn is not None:
            if self._database_list is None:
                self._conn.close()
            self._conn = None
        if self._database_list is not None and getattr(
            tls, "all_established", False
        ):
            for con in tls.all_connections:
                con.close()
            tls.all_connections = []
            tls.all_established = False
            tls.current_database = None

    # -- batched fetch ---------------------------------------------------
    def _query_batch(
        self,
        table: str,
        columns: List[str],
        event_nos: List[int],
        selection: Optional[str] = None,
    ) -> Dict[int, np.ndarray]:
        """One ``WHERE event_no IN (...)`` query, grouped by event with a
        stable sort (the rows of an event keep the per-event query's
        order: both follow the table's scan order)."""
        sql = self.batch_sql(table, columns, event_nos, selection)
        ncols = len(columns) + 1
        arr = self.rows_native(sql, ncols, len(event_nos))
        if arr is None:
            arr = self.rows_sqlite3(sql, ncols)
        grouped: Dict[int, np.ndarray] = {}
        if len(arr):
            order = np.argsort(arr[:, 0], kind="stable")
            arr = arr[order]
            ev = arr[:, 0]
            uniq, starts = np.unique(ev, return_index=True)
            bounds = list(starts) + [len(ev)]
            for u, s, t in zip(uniq, bounds[:-1], bounds[1:]):
                grouped[int(u)] = arr[s:t, 1:]
        empty = np.zeros((0, len(columns)))
        for e in event_nos:
            grouped.setdefault(int(e), empty)
        return grouped

    def batch_sql(
        self,
        table: str,
        columns: List[str],
        event_nos: List[int],
        selection: Optional[str] = None,
    ) -> str:
        """The batched query of :meth:`_query_batch`: the index column
        and ``columns`` of the events ``event_nos``."""
        cols = ", ".join(columns)
        sel = f" and {selection}" if selection else ""
        in_list = ",".join(str(int(e)) for e in event_nos)
        return (
            f"SELECT {self._index_column}, {cols} FROM {table} "
            f"WHERE {self._index_column} IN ({in_list}){sel}"
        )

    def rows_native(
        self, sql: str, ncols: int, n_events: int
    ) -> Optional[np.ndarray]:
        """``sql``'s rows as ``[n, ncols]`` float64 through the native
        fetch; None where it is unavailable or a cell is not numeric."""
        handle = self._native_handle()
        if handle is None:
            return None
        return sqlite_fetch_f64(handle, sql, ncols,
                                cap_hint=max(4096, 128 * n_events))

    def rows_sqlite3(self, sql: str, ncols: int) -> np.ndarray:
        """``sql``'s rows as ``[n, ncols]`` float64 through ``sqlite3``
        (the connection must be open).  A NULL or TEXT cell raises
        ``TypeError`` or ``ValueError`` here, and the callers take the
        per-event route."""
        try:
            rows = self._conn.execute(sql).fetchall()
        except sqlite3.OperationalError as e:
            if "no such column" in str(e):
                raise ColumnMissingException(str(e)) from e
            raise
        if not rows:
            return np.zeros((0, ncols))
        return np.asarray(rows, dtype=np.float64)

    def _batched_ok(self, sequential_indices: List[int]) -> bool:
        """The batched queries carry neither several databases, node
        truth nor loss weights."""
        return (
            self._database_list is None
            and not self._node_truth
            and self._loss_weight_column is None
            and bool(sequential_indices)
        )

    def _fetch_batch(self, sequential_indices: List[int]):
        """``(event_nos, feature groups, truth group)`` in two queries per
        table, or None where a cell is NULL or TEXT."""
        self._establish_connection(sequential_indices[0])
        event_nos = [self._get_event_index(i) for i in sequential_indices]
        try:
            feature_groups = [
                self._query_batch(
                    pm, self._features, event_nos, self._selection
                )
                for pm in self._pulsemaps
            ]
            # self._truth leads with the index column; group on it
            truth_group = self._query_batch(
                self._truth_table, self._truth[1:], event_nos
            )
        except (TypeError, ValueError):
            return None
        return event_nos, feature_groups, truth_group

    def _event_features(self, feature_groups, e) -> np.ndarray:
        feats = [g[e] for g in feature_groups if len(g[e])]
        if not feats:
            return np.zeros((0, len(self._features)))
        return np.concatenate(feats, axis=0)

    def get_batch_arrays(
        self, sequential_indices: List[int]
    ) -> Optional[Tuple[List[np.ndarray], np.ndarray]]:
        """Raw arrays of a whole batch in two SQL queries: per-event
        ``[n_i, n_features]`` float64 feature arrays and a ``[B,
        n_truth]`` truth matrix (the index column first, as
        ``self._truth``).  None where the batched route does not apply
        (several databases, node truth, loss weights, NULL or TEXT
        cells); the caller then takes :meth:`get_events`."""
        if not self._batched_ok(sequential_indices):
            return None
        fetched = self._fetch_batch(sequential_indices)
        if fetched is None:
            return None
        event_nos, feature_groups, truth_group = fetched
        features_list = []
        truth_mat = np.zeros(
            (len(event_nos), len(self._truth)), dtype=np.float64
        )
        for j, e in enumerate(event_nos):
            features_list.append(self._event_features(feature_groups, e))
            truth_rows = truth_group[e]
            if len(truth_rows):
                truth_mat[j, 0] = float(e)
                truth_mat[j, 1:] = truth_rows[0]
        return features_list, truth_mat

    def get_events(self, sequential_indices: List[int]) -> List[Event]:
        """Events of a batch from one SQL query per table; per-event
        queries where the batched route does not apply."""
        fetched = (
            self._fetch_batch(sequential_indices)
            if self._batched_ok(sequential_indices)
            else None
        )
        if fetched is None:
            return [self[i] for i in sequential_indices]
        event_nos, feature_groups, truth_group = fetched
        events = []
        for e in event_nos:
            features = self._event_features(feature_groups, e)
            truth_rows = truth_group[e]
            if len(truth_rows):
                truth = np.concatenate(
                    [[float(e)], truth_rows[0]]
                ).reshape(1, -1)
            else:
                truth = np.zeros((1, len(self._truth)))
            events.append(self._create_graph(features, truth))
        return events
