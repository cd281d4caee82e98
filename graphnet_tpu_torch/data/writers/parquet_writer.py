"""Chunked Parquet writer (counterpart of
``graphnet_tpu/data/writers/parquet_writer.py``).

``merge_files`` writes the layout that
:class:`~graphnet_tpu_torch.data.parquet_dataset.ParquetDataset` reads:
a directory a table, one file a chunk of ``events_per_batch`` events
(``<table>/<table>_<chunk>.parquet``).  pandas is imported inside the
calls.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from graphnet_tpu_torch.data.writers.writer import GraphNeTWriter


class ParquetWriter(GraphNeTWriter):
    """One ``<input>__<table>.parquet`` a table an input file; takes a
    list of DataFrames a table (one an event)."""

    _file_extension = ".parquet"
    _merge_dataframes = False

    def __init__(self, truth_table: str = "truth",
                 index_column: str = "event_no"):
        super().__init__()
        self._truth_table = truth_table
        self._index_column = index_column

    def _save_file(self, data, output_file_path: str, n_events: int):
        import pandas as pd

        base = output_file_path.replace(self._file_extension, "")
        for table, dfs in data.items():
            if isinstance(dfs, list):
                df = pd.concat(dfs, axis=0).reset_index(drop=True)
            else:
                df = dfs
            os.makedirs(os.path.dirname(base), exist_ok=True)
            # '__' parts the input file's stem from the table's name, so
            # merge_files finds names that hold underscores
            df.to_parquet(f"{base}__{table}{self._file_extension}")

    def merge_files(self, files: List[str], output_dir: str,
                    events_per_batch: int = 200000) -> None:
        """Every table of ``files`` into chunks of ``events_per_batch``
        events, by the sorted event ids of the truth table."""
        import pandas as pd

        os.makedirs(output_dir, exist_ok=True)
        tables: Dict[str, List] = {}
        for f in files:
            df = pd.read_parquet(f)
            stem = os.path.basename(f).replace(self._file_extension, "")
            tables.setdefault(stem.split("__")[-1], []).append(df)

        truth_key = None
        for t in tables:
            if t in (self._truth_table, "mc_truth", "truth"):
                truth_key = t
        assert truth_key is not None, f"no truth table among {list(tables)}"
        merged = {t: pd.concat(dfs, axis=0).reset_index(drop=True)
                  for t, dfs in tables.items()}
        event_nos = np.sort(pd.unique(merged[truth_key][self._index_column]))
        chunks = [event_nos[i: i + events_per_batch]
                  for i in range(0, len(event_nos), events_per_batch)]
        for table, df in merged.items():
            table_dir = os.path.join(output_dir, table)
            os.makedirs(table_dir, exist_ok=True)
            for ci, chunk_events in enumerate(chunks):
                sel = df[df[self._index_column].isin(chunk_events)]
                sel.to_parquet(os.path.join(
                    table_dir, f"{table}_{ci}{self._file_extension}"))
        self.info(f"Merged {len(files)} files into {output_dir} "
                  f"({len(chunks)} chunk(s))")
