"""The port's raw-file conversion against the JAX package's on the CPU:
``DataConverter`` with the Prometheus, LiquidO and chunked-Parquet
readers into SQLite and Parquet, ``merge_files`` of both writers, and a
pool of two workers.  Both packages convert the same bundled files; the
outputs are compared exactly: tables, columns and their types, indexes,
row order and every value (``sqlite3``), schemas and tables (pyarrow).
Each JAX conversion runs once for the module."""

import os
import shutil
import sqlite3
from pathlib import Path

import pytest

import graphnet_tpu.data.dataconverter as jdc
from graphnet_tpu.data import pre_configured as jpre
from graphnet_tpu.data.extractors import internal as jinternal
from graphnet_tpu.data.extractors import liquido as jliquido
from graphnet_tpu.data.extractors import prometheus as jprometheus
from graphnet_tpu.data.readers import internal_parquet_reader as jinternal_reader
from graphnet_tpu.data.readers import liquido_reader as jliquido_reader
from graphnet_tpu.data.readers import prometheus_reader as jprometheus_reader
from graphnet_tpu.data.writers import parquet_writer as jparquet_writer
from graphnet_tpu.data.writers import sqlite_writer as jsqlite_writer
import graphnet_tpu_torch.data.dataconverter as tdc
from graphnet_tpu_torch.constants import DATA_DIR, EXAMPLE_PARQUET_DATA
from graphnet_tpu_torch.data import pre_configured as tpre
from graphnet_tpu_torch.data.extractors import internal as tinternal
from graphnet_tpu_torch.data.extractors import liquido as tliquido
from graphnet_tpu_torch.data.extractors import prometheus as tprometheus
from graphnet_tpu_torch.data.readers import internal_parquet_reader as tinternal_reader
from graphnet_tpu_torch.data.readers import liquido_reader as tliquido_reader
from graphnet_tpu_torch.data.readers import prometheus_reader as tprometheus_reader
from graphnet_tpu_torch.data.writers import parquet_writer as tparquet_writer
from graphnet_tpu_torch.data.writers import sqlite_writer as tsqlite_writer

PROMETHEUS_RAW = os.path.join(DATA_DIR, "tests", "prometheus")
LIQUIDO_RAW = os.path.join(DATA_DIR, "tests", "liquid-o")

# each package's modules under one name
PACKAGES = {
    "jax": dict(dc=jdc, pre=jpre, prometheus=jprometheus, liquido=jliquido,
                internal=jinternal, prometheus_reader=jprometheus_reader,
                liquido_reader=jliquido_reader,
                internal_reader=jinternal_reader, sqlite=jsqlite_writer,
                parquet=jparquet_writer),
    "port": dict(dc=tdc, pre=tpre, prometheus=tprometheus, liquido=tliquido,
                 internal=tinternal, prometheus_reader=tprometheus_reader,
                 liquido_reader=tliquido_reader,
                 internal_reader=tinternal_reader, sqlite=tsqlite_writer,
                 parquet=tparquet_writer),
}


def _prometheus(m, writer, outdir, raw=PROMETHEUS_RAW, **kw):
    converter = m["dc"].DataConverter(
        file_reader=m["prometheus_reader"].PrometheusReader(),
        save_method=writer, outdir=str(outdir),
        extractors=[m["prometheus"].PrometheusTruthExtractor(),
                    m["prometheus"].PrometheusFeatureExtractor()], **kw)
    converter(str(raw))
    return converter


def _liquido(m, writer, outdir):
    converter = m["dc"].DataConverter(
        file_reader=m["liquido_reader"].LiquidOReader(),
        save_method=writer, outdir=str(outdir),
        extractors=[m["liquido"].H5HitExtractor(),
                    m["liquido"].H5TruthExtractor()])
    converter(LIQUIDO_RAW)
    return converter


def _three_copies(tmp):
    """Three copies of the Prometheus file: three inputs for the pool
    and for the merge."""
    raw = tmp / "raw"
    raw.mkdir()
    for i in range(3):
        shutil.copy(os.path.join(PROMETHEUS_RAW, "22980001_photons.parquet"),
                    raw / f"file_{i}.parquet")
    return raw


def _convert_all(m, root):
    """Every conversion of this module with package ``m`` under ``root``."""
    root.mkdir()
    _prometheus(m, m["sqlite"].SQLiteWriter(), root / "prometheus_sqlite")
    c = _prometheus(m, m["parquet"].ParquetWriter(truth_table="mc_truth"),
                    root / "prometheus_parquet")
    c.merge_files(events_per_batch=4)
    _liquido(m, m["sqlite"].SQLiteWriter(), root / "liquido_sqlite")
    c = _liquido(m, m["parquet"].ParquetWriter(truth_table="TruthData"),
                 root / "liquido_parquet")
    c.merge_files(events_per_batch=30)
    m["pre"].ParquetToSQLiteConverter(
        parquet_path=EXAMPLE_PARQUET_DATA, sqlite_path=str(root / "internal"),
        tables=["mc_truth", "total"]).run()
    raw = _three_copies(root)
    c = _prometheus(m, m["sqlite"].SQLiteWriter(max_table_size=150),
                    root / "merged_sqlite", raw=raw)
    c.merge_files()
    _prometheus(m, m["sqlite"].SQLiteWriter(), root / "pool", raw=raw,
                num_workers=2)
    return root


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Both packages' outputs of every conversion, in two trees."""
    tmp = tmp_path_factory.mktemp("convert")
    return {name: _convert_all(m, tmp / name) for name, m in PACKAGES.items()}


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def _schema(conn):
    """Every table's and index's SQL, and each table's columns with their
    types, NOT NULL and primary-key flags."""
    master = conn.execute(
        "SELECT type, name, tbl_name, sql FROM sqlite_master "
        "ORDER BY type, name").fetchall()
    columns = {t: conn.execute(f"PRAGMA table_info({t})").fetchall()
               for _, t, _, _ in master if _ == "table"}
    return master, columns


def assert_same_sqlite(got, exp):
    with sqlite3.connect(got) as a, sqlite3.connect(exp) as b:
        sa, sb = _schema(a), _schema(b)
        assert sa == sb
        for table in sa[1]:
            rows_a = a.execute(f"SELECT * FROM {table} ORDER BY rowid").fetchall()
            rows_b = b.execute(f"SELECT * FROM {table} ORDER BY rowid").fetchall()
            assert len(rows_a) == len(rows_b) > 0, table
            assert rows_a == rows_b, table
            types_a = a.execute(
                f"SELECT * FROM {table} LIMIT 1").description
            assert types_a == b.execute(
                f"SELECT * FROM {table} LIMIT 1").description


def assert_same_parquet(got, exp):
    import pyarrow.parquet as pq

    ta, tb = pq.read_table(got), pq.read_table(exp)
    assert ta.schema.equals(tb.schema, check_metadata=True), (ta.schema,
                                                               tb.schema)
    assert ta.num_rows == tb.num_rows > 0
    assert ta.equals(tb)


def _assert_same_tree(outputs, name, suffixes=(".db", ".parquet")):
    got, exp = outputs["port"] / name, outputs["jax"] / name
    files = _files(got)
    assert files and files == _files(exp)
    for f in files:
        if f.endswith(".db"):
            assert_same_sqlite(got / f, exp / f)
        else:
            assert f.endswith(".parquet")
            assert_same_parquet(got / f, exp / f)
    return files


def test_prometheus_to_sqlite(outputs):
    """One database, ``mc_truth`` (``event_no`` the primary key) and
    ``photons`` (``event_no`` indexed), as the JAX package writes it."""
    files = _assert_same_tree(outputs, "prometheus_sqlite")
    assert files == ["22980001_photons.db"]
    with sqlite3.connect(outputs["port"] / "prometheus_sqlite" / files[0]) as c:
        assert c.execute("SELECT COUNT(*) FROM mc_truth").fetchone()[0] == 10
        pk = [r[1] for r in c.execute("PRAGMA table_info(mc_truth)") if r[5]]
        assert pk == ["event_no"]
        assert c.execute("SELECT COUNT(DISTINCT event_no) FROM photons"
                         ).fetchone()[0] == 9


def test_prometheus_to_parquet_and_merge(outputs):
    """The per-file tables and the merged chunks of 4 events."""
    files = _assert_same_tree(outputs, "prometheus_parquet")
    assert "22980001_photons__mc_truth.parquet" in files
    assert [f for f in files if f.startswith("merged/mc_truth/")] == [
        f"merged/mc_truth/mc_truth_{i}.parquet" for i in range(3)]


def test_liquido_to_sqlite(outputs):
    """The h5 tables with their own ``event_no``: 100 events."""
    files = _assert_same_tree(outputs, "liquido_sqlite")
    with sqlite3.connect(outputs["port"] / "liquido_sqlite" / files[0]) as c:
        assert c.execute("SELECT COUNT(*) FROM TruthData").fetchone()[0] == 100


def test_liquido_to_parquet_and_merge(outputs):
    files = _assert_same_tree(outputs, "liquido_parquet")
    assert "merged/HitData/HitData_0.parquet" in files


def test_parquet_to_sqlite_converter(outputs):
    """``ParquetToSQLiteConverter`` on the bundled chunked Parquet: one
    database a chunk file, then ``merged/merged.db``."""
    files = _assert_same_tree(outputs, "internal")
    assert "merged/merged.db" in files
    with sqlite3.connect(outputs["port"] / "internal" / "merged" / "merged.db") as c:
        assert c.execute("SELECT COUNT(DISTINCT event_no) FROM mc_truth"
                         ).fetchone()[0] == 50


def test_sqlite_merge_partitions(outputs):
    """Three inputs merged with ``max_table_size`` 150: a new partition
    where a table would pass it, the same files and rows as JAX's."""
    files = _assert_same_tree(outputs, "merged_sqlite")
    assert [f for f in files if f.startswith("merged/")] == [
        "merged/merged_0.db", "merged/merged_1.db", "merged/merged_2.db"]


def test_pool_of_two_workers(outputs):
    """Two workers over three files: the tables and columns of JAX's, and
    every event a unique ``event_no``; the numbers as a set are JAX's (a
    pool's order is free)."""

    def event_nos(root):
        out, photons = [], set()
        for db in sorted((root / "pool").glob("*.db")):
            with sqlite3.connect(db) as c:
                out += [r[0] for r in c.execute("SELECT event_no FROM mc_truth")]
                photons |= {r[0] for r in c.execute(
                    "SELECT DISTINCT event_no FROM photons")}
        return out, photons

    got, got_photons = event_nos(outputs["port"])
    exp, _ = event_nos(outputs["jax"])
    assert len(got) == len(set(got)) == 30
    assert set(got) == set(exp) == set(range(30))
    assert got_photons <= set(got) and len(got_photons) == 27
    assert _files(outputs["port"] / "pool") == _files(outputs["jax"] / "pool")
    for f in _files(outputs["port"] / "pool"):
        with sqlite3.connect(outputs["port"] / "pool" / f) as a, \
                sqlite3.connect(outputs["jax"] / "pool" / f) as b:
            assert _schema(a) == _schema(b)


def test_converter_details():
    """The output names, the readers' file lists, the extractor checks,
    ``_count_rows`` and a single file not merged."""
    for m in PACKAGES.values():
        conv = m["dc"].DataConverter(
            m["prometheus_reader"].PrometheusReader(),
            m["sqlite"].SQLiteWriter(), "/unused",
            m["prometheus"].PrometheusTruthExtractor())
        assert conv._create_file_name("/a/b/f.i3.parquet") == "f"
        assert conv._file_reader.extractor_names == ["mc_truth"]
        with pytest.raises(TypeError, match="not supported"):
            m["liquido_reader"].LiquidOReader().set_extractors(
                [m["prometheus"].PrometheusTruthExtractor()])
        with pytest.raises(AssertionError, match="differing"):
            conv._count_rows({"a": [1, 2], "b": [1]})
        assert conv._count_rows({"a": 3, "b": 4}) == 1
        assert conv._count_rows({}) == 0
        conv.merge_files("/unused/one.db")  # a single file: no merge
    for key in ("prometheus_reader", "liquido_reader", "internal_reader"):
        reader = {"prometheus_reader": "PrometheusReader",
                  "liquido_reader": "LiquidOReader",
                  "internal_reader": "ParquetReader"}[key]
        raw = {"prometheus_reader": PROMETHEUS_RAW,
               "liquido_reader": LIQUIDO_RAW,
               "internal_reader": EXAMPLE_PARQUET_DATA}[key]
        got = getattr(PACKAGES["port"][key], reader)().find_files(raw)
        exp = getattr(PACKAGES["jax"][key], reader)().find_files(raw)
        assert got == exp and got


def test_extractors_match_jax():
    """The extractors alone: a Prometheus record with a missing column
    (warned once, left empty), the h5 tables, a chunk file of the
    internal format and one of another table."""
    import pandas as pd

    record = {"sensor_pos_x": [1.0, 2.0], "t": 3.5, "sensor_id": [4, 5]}
    got = tprometheus.PrometheusFeatureExtractor()(record)
    assert got == jprometheus.PrometheusFeatureExtractor()(record)
    assert got["sensor_pos_y"] == [] and got["t"] == [3.5]
    h5 = os.path.join(LIQUIDO_RAW, "liquido_electrons.h5")
    for cls in ("H5HitExtractor", "H5TruthExtractor"):
        pd.testing.assert_frame_equal(getattr(tliquido, cls)()(h5),
                                      getattr(jliquido, cls)()(h5))
    assert tliquido.H5Extractor("NoSuchTable", ["a"])(h5) is None
    chunk = os.path.join(EXAMPLE_PARQUET_DATA, "total", "total_3.parquet")
    pd.testing.assert_frame_equal(tinternal.ParquetExtractor("total")(chunk),
                                  jinternal.ParquetExtractor("total")(chunk))
    assert tinternal.ParquetExtractor("mc_truth")(chunk) is None
