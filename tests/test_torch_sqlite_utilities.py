"""The port's ``sqlite_utilities`` against the JAX package's on copies of
the bundled database: each function's answer, and the database each
leaves behind, compared exactly."""

import shutil
import sqlite3

import pandas as pd
import pytest

from graphnet_tpu.data import sqlite_utilities as jsu
from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data import sqlite_utilities as tsu
from graphnet_tpu_torch.data.writers import sqlite_writer


@pytest.fixture()
def dbs(tmp_path):
    """A copy of the bundled database for each package."""
    out = {}
    for name in ("jax", "port"):
        out[name] = str(tmp_path / f"{name}.db")
        shutil.copy(EXAMPLE_SQLITE_DATA, out[name])
    return out


def _dump(path):
    """The database's schema and every row of every table."""
    with sqlite3.connect(path) as conn:
        master = conn.execute("SELECT type, name, tbl_name, sql FROM "
                              "sqlite_master ORDER BY type, name").fetchall()
        rows = {t: conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                for k, t, _, _ in master if k == "table"}
    return master, rows


def test_reads_match_jax(dbs):
    """``database_exists``, ``database_table_exists``, ``get_all_tables``,
    ``get_primary_keys``, ``get_event_numbers`` and ``query_database`` on
    the bundled database."""
    db = dbs["port"]
    assert tsu.database_exists(db) and jsu.database_exists(db)
    assert not tsu.database_exists(db + ".missing.db")
    for mod in (tsu, jsu):
        with pytest.raises(ValueError, match="expected a .db path"):
            mod.database_exists(db + ".txt")
    assert tsu.get_all_tables(db) == jsu.get_all_tables(db)
    assert set(tsu.get_all_tables(db)) >= {"mc_truth", "total"}
    for table in ("mc_truth", "total", "missing"):
        assert tsu.database_table_exists(db, table) == \
            jsu.database_table_exists(db, table)
    assert not tsu.database_table_exists(db + ".missing.db", "mc_truth")
    assert tsu.get_primary_keys(db) == jsu.get_primary_keys(db)
    for table in ("mc_truth", "total"):
        got = tsu.get_event_numbers(db, table)
        assert got == jsu.get_event_numbers(db, table) and len(got) == 50
    query = "SELECT * FROM total WHERE event_no < 200 ORDER BY event_no, t"
    got, exp = tsu.query_database(db, query), jsu.query_database(db, query)
    assert isinstance(got, pd.DataFrame) and len(got) > 0
    pd.testing.assert_frame_equal(got, exp)


def test_writes_match_jax(dbs):
    """``run_sql_code``, ``attach_index`` and ``save_to_sql`` (a table
    with one row an event: ``event_no`` the primary key; one with many:
    indexed) leave the same database as the JAX functions."""
    per_event = pd.DataFrame({"event_no": [0, 1, 2], "w": [0.5, 1.5, 2.5],
                              "flag": [True, False, True]})
    per_pulse = pd.DataFrame({"event_no": [0, 0, 1], "q": [1, 2, 3],
                              "name": ["a", "b", "c"]})
    for name, mod in (("jax", jsu), ("port", tsu)):
        db = dbs[name]
        mod.run_sql_code(db, "CREATE TABLE extra (event_no INTEGER, w FLOAT);")
        mod.attach_index(db, "extra")
        mod.save_to_sql(per_event, "weights", db)
        mod.save_to_sql(per_pulse, "per_pulse", db, "event_no")
    assert _dump(dbs["port"]) == _dump(dbs["jax"])
    keys, key = tsu.get_primary_keys(dbs["port"])
    assert keys["weights"] == "event_no" and keys["per_pulse"] is None
    assert key == "event_no"
    # the writer's functions, exported here too
    assert tsu.save_to_sql is sqlite_writer.save_to_sql
    assert tsu.create_table is sqlite_writer.create_table


def test_create_table_types_match_jax(tmp_path):
    """``create_table``'s column types for each pandas kind, with and
    without the primary key; a table that exists is left as it is."""
    df = pd.DataFrame({"event_no": [1], "i": [2], "f": [0.5], "b": [True],
                       "s": ["x"]})
    sql = {}
    for name, mod in (("jax", jsu), ("port", tsu)):
        db = str(tmp_path / f"{name}.db")
        with sqlite3.connect(db) as conn:
            mod.create_table(conn, "a", df, "event_no", primary_key=True)
            mod.create_table(conn, "b", df, "event_no", primary_key=False)
            mod.create_table(conn, "b", df.drop(columns="s"), "event_no",
                             primary_key=False)
        sql[name] = _dump(db)
    assert sql["port"] == sql["jax"]
    tables = {name: text for kind, name, _, text in sql["port"][0]
              if kind == "table"}
    assert "event_no INTEGER PRIMARY KEY NOT NULL" in tables["a"]
    assert tables["b"] == ("CREATE TABLE b (event_no INTEGER, i INTEGER, "
                           "f FLOAT, b INTEGER, s BLOB)")


def test_distinct_primary_keys_raise(tmp_path):
    """Two tables with different primary keys: both packages raise."""
    for name, mod in (("jax", jsu), ("port", tsu)):
        db = str(tmp_path / f"{name}.db")
        mod.run_sql_code(db, "CREATE TABLE a (event_no INTEGER PRIMARY KEY, "
                             "x FLOAT); CREATE TABLE b (id INTEGER PRIMARY "
                             "KEY, y FLOAT);")
        with pytest.raises(ValueError, match="multiple distinct primary keys"):
            mod.get_primary_keys(db)
