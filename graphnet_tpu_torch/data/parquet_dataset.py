"""Chunked Parquet dataset (counterpart of
``graphnet_tpu/data/parquet_dataset.py``).

The layout ``ParquetWriter`` writes: a directory a table, a file a chunk
of events (``<table>/<table>_<chunk>.parquet``).  A selection is a list
of chunk ids; a sequential index maps to (chunk, row) through the
cumulative chunk sizes, with an LRU cache of decoded chunks.  Read with
pyarrow alone (imported inside the calls), not pandas, which the GPU
host may lack: each chunk is sorted by the index column (stable), and a
pulse table grouped by event, as the JAX package's pandas code does.
"""

from __future__ import annotations

import os
from bisect import bisect_right
from collections import OrderedDict
from glob import glob
from typing import Dict, List, Optional, Union

import numpy as np

from graphnet_tpu_torch.data.dataset import ColumnMissingException, Dataset


def _rows(columns: Dict[str, np.ndarray], names: List[str]) -> np.ndarray:
    """``[n, len(names)]`` of the named columns, in numpy's common dtype
    (pandas' ``DataFrame.to_numpy`` for numeric columns)."""
    return np.stack([columns[c] for c in names], axis=1)


class ParquetDataset(Dataset):
    """Dataset over ParquetWriter-style chunked directories."""

    def __init__(self, *args, cache_size: int = 1, **kwargs):
        self._cache_size = max(cache_size, 1)
        super().__init__(*args, **kwargs)
        if not isinstance(self._path, str):
            raise ValueError("ParquetDataset takes one directory")
        if any(isinstance(i, str) for i in self._indices):
            raise ValueError("ParquetDataset does not support str selections")
        self._chunk_sizes = self._calculate_sizes()
        self._chunk_cumsum = np.cumsum(self._chunk_sizes)
        self._file_cache: Dict[str, OrderedDict] = {}
        self._remove_missing_columns()

    # --- base-class hooks ---------------------------------------------------
    def _init(self) -> None:
        self._file_cache = {}

    def _get_all_indices(self) -> List[int]:
        files = glob(os.path.join(self._path, self._truth_table, "*.parquet"))
        return list(range(len(files)))

    def _get_event_index(self, sequential_index: Optional[int]) -> int:
        res = self.query_table(
            self._truth_table, [self._index_column], sequential_index)
        return int(np.asarray(res).reshape(-1)[0])

    def __len__(self) -> int:
        return int(sum(self._chunk_sizes))

    @property
    def chunk_sizes(self) -> List[int]:
        return self._chunk_sizes

    # --- chunk bookkeeping --------------------------------------------------
    def _chunk_path(self, table: str, chunk_id: int) -> str:
        return os.path.join(self._path, table, f"{table}_{chunk_id}.parquet")

    def _calculate_sizes(self) -> List[int]:
        import pyarrow.parquet as pq

        return [
            pq.ParquetFile(
                self._chunk_path(self._truth_table, cid)).metadata.num_rows
            for cid in self._indices
        ]

    def _get_row_idx(self, sequential_index: int) -> int:
        file_idx = bisect_right(self._chunk_cumsum, sequential_index)
        if file_idx > 0:
            return int(sequential_index - self._chunk_cumsum[file_idx - 1])
        return sequential_index

    def _load_table(self, table: str, chunk_id: int):
        """A chunk, LRU-cached: ``("pulse", sorted event numbers, {event:
        columns})`` for a pulse table, ``("event", event numbers,
        columns)`` for an event table; the rows sorted by the index
        column (stable)."""
        import pyarrow.parquet as pq

        cache = self._file_cache.setdefault(table, OrderedDict())
        if chunk_id in cache:
            cache.move_to_end(chunk_id)
            return cache[chunk_id]
        data = pq.read_table(self._chunk_path(table, chunk_id))
        columns = {name: data.column(name).to_numpy()
                   for name in data.column_names
                   if not name.startswith("__index_level_")}
        order = np.argsort(columns[self._index_column], kind="stable")
        columns = {k: v[order] for k, v in columns.items()}
        keys = columns[self._index_column]
        if table in self._pulsemaps or table == self._node_truth_table:
            uniq, starts = np.unique(keys, return_index=True)
            bounds = list(starts) + [len(keys)]
            groups = {
                u: {k: v[s:t] for k, v in columns.items()}
                for u, s, t in zip(uniq.tolist(), bounds[:-1], bounds[1:])
            }
            entry = ("pulse", sorted(groups), groups)
        else:
            entry = ("event", keys, columns)
        cache[chunk_id] = entry
        while len(cache) > self._cache_size:
            cache.popitem(last=False)
        return entry

    # --- queries ------------------------------------------------------------
    def query_table(
        self,
        table: str,
        columns: Union[List[str], str],
        sequential_index: Optional[int] = None,
        selection: Optional[str] = None,
    ) -> np.ndarray:
        if isinstance(columns, str):
            columns = [columns]
        if sequential_index is None:
            file_ids = list(range(len(self._chunk_cumsum)))
        else:
            file_ids = [bisect_right(self._chunk_cumsum, sequential_index)]
        arrays = []
        for fid in file_ids:
            chunk_id = self._indices[fid]
            kind, keys, data = self._load_table(table, chunk_id)
            if sequential_index is not None:
                row = self._get_row_idx(sequential_index)
                if kind == "pulse":
                    # the truth table orders the events of a chunk
                    _, truth_keys, _ = self._load_table(
                        self._truth_table, chunk_id)
                    group = data.get(int(truth_keys[row]))
                    if group is None:
                        arrays.append(np.zeros((0, len(columns)), np.float64))
                        continue
                    self._check_columns(group, columns, table)
                    arrays.append(_rows(group, columns))
                else:
                    self._check_columns(data, columns, table)
                    arrays.append(_rows(
                        {c: data[c][row:row + 1] for c in columns}, columns))
            elif kind == "pulse":
                parts = [_rows(g, columns) for _, g in sorted(data.items())]
                arrays.append(np.concatenate(parts, axis=0) if parts
                              else np.zeros((0, len(columns))))
            else:
                self._check_columns(data, columns, table)
                arrays.append(_rows(data, columns))
        return np.concatenate(arrays, axis=0)

    def _check_columns(self, data, columns, table) -> None:
        for c in columns:
            if c not in data:
                raise ColumnMissingException(f"{c} not in {table}")

    def _remove_missing_columns(self) -> None:
        if len(self) == 0:
            return
        for col in list(self._features):
            try:
                for pm in self._pulsemaps:
                    self.query_table(pm, [col], 0)
            except ColumnMissingException:
                self._features.remove(col)
        for col in list(self._truth):
            try:
                self.query_table(self._truth_table, [col], 0)
            except ColumnMissingException:
                self._truth.remove(col)

    def event_lengths(self) -> List[int]:
        """Pulse count per event over all chunks (for bucketed batching)."""
        lengths: List[int] = []
        for chunk_id in self._indices:
            _, truth_keys, _ = self._load_table(self._truth_table, chunk_id)
            counts: Dict[int, int] = {}
            for pm in self._pulsemaps:
                _, _, groups = self._load_table(pm, chunk_id)
                for k, g in groups.items():
                    counts[k] = counts.get(k, 0) + len(g[self._index_column])
            lengths.extend(counts.get(int(k), 0) for k in truth_keys)
        return lengths
