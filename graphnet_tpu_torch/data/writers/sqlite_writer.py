"""SQLite writer (counterpart of
``graphnet_tpu/data/writers/sqlite_writer.py``).

One table an extractor; ``event_no`` is the integer primary key of a
table with one row an event, and an indexed column otherwise.
``merge_files`` concatenates many small databases, and starts a new
partition where a table would pass ``max_table_size`` rows.  pandas is
imported inside the calls.
"""

from __future__ import annotations

import os
import sqlite3
from typing import List, Optional

from graphnet_tpu_torch.data.writers.writer import GraphNeTWriter


def _is_one_row_per_event(df, index_column: str) -> bool:
    return df[index_column].is_unique


def create_table(
    conn: sqlite3.Connection,
    table: str,
    df,
    index_column: str,
    primary_key: bool,
) -> None:
    """Create ``table`` with ``df``'s columns (integers and booleans as
    INTEGER, floats as FLOAT, anything else BLOB) unless it exists:
    ``index_column`` the primary key, or else indexed."""
    type_map = {"i": "INTEGER", "f": "FLOAT", "b": "INTEGER"}
    cols = []
    for name, dtype in df.dtypes.items():
        sql_type = type_map.get(dtype.kind, "BLOB")
        if name == index_column and primary_key:
            cols.append(f"{name} INTEGER PRIMARY KEY NOT NULL")
        else:
            cols.append(f"{name} {sql_type}")
    conn.execute(f"CREATE TABLE IF NOT EXISTS {table} ({', '.join(cols)})")
    if not primary_key:
        conn.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{table}_{index_column} "
            f"ON {table} ({index_column})"
        )


def save_to_sql(df, table: str, database_path: str,
                index_column: str = "event_no") -> None:
    """Append ``df`` to ``table`` of the database, creating both as
    needed (``index_column`` the primary key where it is unique)."""
    with sqlite3.connect(database_path) as conn:
        create_table(conn, table, df, index_column,
                     primary_key=_is_one_row_per_event(df, index_column))
        df.to_sql(table, conn, if_exists="append", index=False)


class SQLiteWriter(GraphNeTWriter):
    """One ``.db`` an input file; ``merge_files`` into
    ``merged_database_name`` (``_<partition>`` before its extension with
    ``max_table_size``)."""

    _file_extension = ".db"
    _merge_dataframes = True

    def __init__(
        self,
        merged_database_name: str = "merged.db",
        max_table_size: Optional[int] = None,
        index_column: str = "event_no",
    ):
        super().__init__()
        self._merged_database_name = merged_database_name
        self._max_table_size = max_table_size
        self._index_column = index_column

    def _save_file(self, data, output_file_path: str, n_events: int):
        if n_events == 0:
            self.warning(f"No events in {output_file_path}; skipping.")
            return
        for table, df in data.items():
            if len(df):
                save_to_sql(df, table, output_file_path, self._index_column)

    def merge_files(
        self,
        files: List[str],
        output_dir: str,
        primary_key_rescue: str = "event_no",
    ) -> None:
        import pandas as pd

        os.makedirs(output_dir, exist_ok=True)
        partition = 0
        rows_in_partition = 0
        out_path = self._partition_path(output_dir, partition)
        for f in files:
            with sqlite3.connect(f) as conn:
                tables = [r[0] for r in conn.execute(
                    "SELECT name FROM sqlite_master WHERE type='table'")]
                frames = {t: pd.read_sql(f"SELECT * FROM {t}", conn)
                          for t in tables}
            n = max((len(df) for df in frames.values()), default=0)
            if (
                self._max_table_size is not None
                and rows_in_partition
                and rows_in_partition + n > self._max_table_size
            ):
                partition += 1
                rows_in_partition = 0
                out_path = self._partition_path(output_dir, partition)
            for t, df in frames.items():
                if len(df):
                    save_to_sql(df, t, out_path, self._index_column)
            rows_in_partition += n
        self.info(f"Merged {len(files)} files into {output_dir}")

    def _partition_path(self, output_dir: str, partition: int) -> str:
        name = self._merged_database_name
        if self._max_table_size is not None:
            stem, ext = os.path.splitext(name)
            name = f"{stem}_{partition}{ext}"
        return os.path.join(output_dir, name)
