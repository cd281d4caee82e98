"""SQLite helpers for the intermediate-format databases (counterpart of
``graphnet_tpu/data/sqlite_utilities.py``).  ``create_table`` and
``save_to_sql`` live in
:mod:`graphnet_tpu_torch.data.writers.sqlite_writer` and are exported
here too.  pandas is imported only by :func:`query_database`, which
returns a DataFrame, so the module imports on a host without it."""

from __future__ import annotations

import os
import sqlite3
from typing import Any, List

from graphnet_tpu_torch.data.writers.sqlite_writer import (  # noqa: F401
    create_table,
    save_to_sql,
)


def database_exists(database_path: str) -> bool:
    """Whether ``database_path``, a ``.db`` path, exists."""
    if not database_path.endswith(".db"):
        raise ValueError(f"expected a .db path, got {database_path!r}")
    return os.path.exists(database_path)


def run_sql_code(database_path: str, code: str) -> None:
    """Run an SQL script on the database."""
    with sqlite3.connect(database_path) as conn:
        conn.executescript(code)


def database_table_exists(database_path: str, table_name: str) -> bool:
    """Whether the database exists and holds ``table_name``."""
    if not database_exists(database_path):
        return False
    with sqlite3.connect(database_path) as conn:
        rows = conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name=?",
            (table_name,),
        ).fetchall()
    return len(rows) > 0


def query_database(database_path: str, query: str):
    """The rows of a SELECT as a pandas DataFrame."""
    import pandas as pd

    with sqlite3.connect(database_path) as conn:
        return pd.read_sql(query, conn)


def get_primary_keys(database_path: str) -> tuple:
    """``(keys, key_name)``: each table's integer primary key column (or
    None), and the one name they share (the event index, ``event_no``);
    raises ``ValueError`` where tables name different keys."""
    with sqlite3.connect(database_path) as conn:
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table'")]
        keys = {}
        for table in tables:
            pk = [r[1] for r in conn.execute(f"PRAGMA table_info({table})")
                  if r[5]]  # the pk flag
            keys[table] = pk[0] if pk else None
    names = {k for k in keys.values() if k is not None}
    if len(names) > 1:
        raise ValueError(f"multiple distinct primary keys across tables: {names}")
    return keys, (names.pop() if names else None)


def attach_index(database_path: str, table_name: str,
                 index_column: str = "event_no") -> None:
    """Index ``index_column`` of a table (``<index_column>_<table>``)."""
    code = (
        "PRAGMA foreign_keys=off;\n"
        "BEGIN TRANSACTION;\n"
        f"CREATE INDEX IF NOT EXISTS {index_column}_{table_name} "
        f"ON {table_name} ({index_column});\n"
        "COMMIT TRANSACTION;\n"
        "PRAGMA foreign_keys=on;"
    )
    run_sql_code(database_path, code)


def get_all_tables(database_path: str) -> List[str]:
    """Every table's name."""
    with sqlite3.connect(database_path) as conn:
        return [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table'")]


def get_event_numbers(database_path: str, table: str,
                      index_column: str = "event_no") -> List[Any]:
    """The distinct event ids of ``table``."""
    with sqlite3.connect(database_path) as conn:
        return [r[0] for r in conn.execute(
            f"SELECT DISTINCT {index_column} FROM {table}")]
