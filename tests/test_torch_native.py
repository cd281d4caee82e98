"""The port's native host code (``graphnet_tpu_torch/native.py``, built
from ``graphnet_tpu_torch/csrc/host``) against its plain routes and the
JAX package's bindings: the padding and the SQLite fetch bit for bit,
the retry at the exact size, the fallbacks (a non-numeric cell, several
databases, no library), the per-thread handles and the call counters."""

import os
import sqlite3
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from graphnet_tpu import native as jax_native
from graphnet_tpu_torch import native
from graphnet_tpu_torch.batch import pad_events
from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataloader import DataLoader, collate_events
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.kernels.build import BUILD_DIR
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.graphs import KNNGraph
from graphnet_tpu_torch.models.graphs.graph_definition import Event

torch.set_num_threads(2)

ARGS = dict(pulsemaps="total", truth_table="mc_truth",
            features=FEATURES.PROMETHEUS, truth=TRUTH.PROMETHEUS)


def _dataset(path=EXAMPLE_SQLITE_DATA, **kw):
    return SQLiteDataset(path, KNNGraph(detector=Prometheus()), **ARGS, **kw)


def _ragged(seed, D=5):
    rng = np.random.default_rng(seed)
    # empty, short, and longer than the padded length
    return [rng.standard_normal((n, D)).astype(np.float64)
            for n in (0, 1, 7, 40, 70, 3)]


def test_libraries_build_into_the_ports_build_directory():
    for name in ("collate", "sqlite_fetch"):
        assert native.get_lib(name) is not None
        path = native.library_path(name)
        assert path.parent == BUILD_DIR and path.exists()
        assert path.name.startswith(f"host_{name}-")
    loaded = {os.path.realpath(p) for p in _mapped_libraries()}
    assert os.path.realpath(native.library_path("collate")) in loaded
    assert not any(p.endswith(("native/_collate.so", "native/_sqlite_fetch.so"))
                   for p in loaded if "graphnet_tpu_torch" in p)
    assert native.gxx_version().startswith("g++")


def _mapped_libraries():
    with open("/proc/self/maps") as f:
        return [line.split()[-1] for line in f if line.rstrip().endswith(".so")]


@pytest.mark.parametrize("L", [16, 64, 128])
def test_padding_matches_numpy_and_jax(L):
    """``native_pad_events`` against ``batch.pad_events`` (numpy) and the
    JAX package's native padding: the same bits, events longer than L
    truncated."""
    xs = _ragged(L)
    before = native.native_pad_events.calls
    got = native.native_pad_events(xs, L)
    assert native.native_pad_events.calls == before + 1
    plain = pad_events(xs, length=L)
    exp = jax_native.native_pad_events(xs, L)
    for g, p, e in zip(got, plain, exp):
        assert g.dtype == p.dtype == e.dtype
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, e)


def test_node_label_padding_matches_numpy():
    rng = np.random.default_rng(4)
    labels = [rng.standard_normal(n) for n in (0, 5, 20)]
    got = native.native_pad_node_labels(labels, 16)
    exp = np.zeros((3, 16), np.float32)
    for i, v in enumerate(labels):
        exp[i, :min(len(v), 16)] = v[:16]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, exp)


def test_collate_takes_the_native_padding_with_node_labels():
    rng = np.random.default_rng(5)
    events = [Event(x=rng.standard_normal((n, 4)).astype(np.float32),
                    features=list("xyzt"),
                    labels={"energy": float(n)},
                    node_labels={"hit": rng.random(n)})
              for n in (3, 9, 12)]
    calls = (native.native_pad_events.calls,
             native.native_pad_node_labels.calls)
    batch = collate_events(events)
    assert native.native_pad_events.calls == calls[0] + 1
    assert native.native_pad_node_labels.calls == calls[1] + 1
    x, mask, n = pad_events([e.x for e in events], length=16)
    np.testing.assert_array_equal(batch.x.numpy(), x)
    np.testing.assert_array_equal(batch.mask.numpy(), mask)
    np.testing.assert_array_equal(batch.n_pulses.numpy(), n)
    for i, e in enumerate(events):
        hit = batch.node_labels["hit"][i].numpy()
        np.testing.assert_array_equal(hit[:e.n_pulses],
                                      e.node_labels["hit"].astype(np.float32))
        assert not hit[e.n_pulses:].any()


def _batch_queries(ds, idxs):
    event_nos = [ds._get_event_index(i) for i in idxs]
    return [
        (ds.batch_sql("total", ds._features, event_nos), len(ds._features) + 1),
        (ds.batch_sql("mc_truth", ds._truth[1:], event_nos), len(ds._truth)),
    ]


def test_sqlite_fetch_matches_sqlite3_and_jax():
    """The batched queries of a batch through the port's native fetch,
    through ``sqlite3`` and through the JAX package's fetch: the same
    float64 arrays; a result beyond ``cap_hint`` is fetched again at its
    exact size (two calls)."""
    ds = _dataset()
    ds._establish_connection(0)
    handle = native.sqlite_open(EXAMPLE_SQLITE_DATA)
    jax_handle = jax_native.sqlite_open(EXAMPLE_SQLITE_DATA)
    try:
        for sql, ncols in _batch_queries(ds, [3, 1, 4, 15, 9, 26]):
            plain = ds.rows_sqlite3(sql, ncols)
            before = native.sqlite_fetch_f64.calls
            got = native.sqlite_fetch_f64(handle, sql, ncols)
            assert native.sqlite_fetch_f64.calls == before + 1
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got, plain)
            np.testing.assert_array_equal(
                got, jax_native.sqlite_fetch_f64(jax_handle, sql, ncols))
            small = native.sqlite_fetch_f64(handle, sql, ncols, cap_hint=1)
            assert native.sqlite_fetch_f64.calls == before + (
                3 if len(plain) > 16 else 2)
            np.testing.assert_array_equal(small, plain)
    finally:
        native.sqlite_close(handle)
        jax_native.sqlite_close(jax_handle)
        ds._close_connection()


def test_sqlite_fetch_falls_back_on_non_numeric_cells(tmp_path):
    """A NULL or TEXT cell, or an error, gives None (as in the JAX
    package); the dataset then takes ``sqlite3``, whose TEXT cell sends
    the batch to the per-event route."""
    db = str(tmp_path / "cells.db")
    con = sqlite3.connect(db)
    con.execute("CREATE TABLE t (a, b)")
    con.executemany("INSERT INTO t VALUES (?, ?)",
                    [(1, 2.5), (2, None), (3, "x")])
    con.commit()
    con.close()
    handle = native.sqlite_open(db)
    try:
        assert native.sqlite_fetch_f64(handle, "SELECT a, b FROM t WHERE a = 1",
                                       2).tolist() == [[1.0, 2.5]]
        for sql in ("SELECT a, b FROM t WHERE a = 2",
                    "SELECT a, b FROM t WHERE a = 3",
                    "SELECT a, nope FROM t", "SELECT a FROM t"):
            assert native.sqlite_fetch_f64(handle, sql, 2) is None, sql
            assert jax_native.sqlite_fetch_f64(
                jax_native.sqlite_open(db), sql, 2) is None
    finally:
        native.sqlite_close(handle)
    assert native.sqlite_open(str(tmp_path / "missing" / "x.db")) is None


def test_dataset_fetch_native_equals_plain():
    """``get_batch_arrays`` with the native fetch and with ``sqlite3``
    alone (no handle): the same arrays; the native counter rises only on
    the first."""
    ds = _dataset()
    idxs = [5, 0, 33, 12, 49]
    before = native.sqlite_fetch_f64.calls
    got = ds.get_batch_arrays(idxs)
    assert native.sqlite_fetch_f64.calls == before + 2
    ds._tls.native_handle = False  # as where the library is unavailable
    exp = ds.get_batch_arrays(idxs)
    assert native.sqlite_fetch_f64.calls == before + 2
    for a, b in zip(got[0], exp[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], exp[1])


def test_several_databases_take_sqlite3():
    con = sqlite3.connect(EXAMPLE_SQLITE_DATA)
    first, second = [r[0] for r in con.execute(
        "SELECT event_no FROM mc_truth LIMIT 2")]
    con.close()
    ds = _dataset(path=[EXAMPLE_SQLITE_DATA, EXAMPLE_SQLITE_DATA],
                  selection=[(first, 0), (second, 1)])
    assert ds._native_handle() is None
    single = _dataset()
    np.testing.assert_array_equal(ds[1].x, single[1].x)


def test_handles_per_thread_and_dropped_by_pickle():
    """Each loader thread opens its own handle; the pickled state carries
    none; the threads' batches equal the serial ones."""
    ds = _dataset()
    main = ds._native_handle()
    with ThreadPoolExecutor(2) as pool:
        handles = set(pool.map(lambda _: ds._native_handle(), range(8)))
    assert main and main not in handles and None not in handles
    assert len(handles) <= 2
    state = ds.__getstate__()  # what pickling carries: no handle
    assert "_tls_store" not in state
    again = SQLiteDataset.__new__(SQLiteDataset)
    again.__dict__.update(state)
    assert "native_handle" not in vars(again._tls)
    serial = list(DataLoader(ds, batch_size=8, shuffle=True, seed=1))
    threaded = list(DataLoader(again, batch_size=8, shuffle=True, seed=1,
                               num_workers=2))
    assert len(serial) == len(threaded) == 7
    for a, b in zip(serial, threaded):
        assert a.signature() == b.signature()
        for x, y in zip(a.tensors().values(), b.tensors().values()):
            assert torch.equal(x, y)


def test_loader_without_the_libraries_takes_the_plain_routes(monkeypatch):
    """No library (no compiler): the same batches through numpy and
    ``sqlite3``, and no native call."""
    exp = list(DataLoader(_dataset(), batch_size=16, shuffle=True, seed=2))
    monkeypatch.setattr(native, "_libs",
                        {"collate": None, "sqlite_fetch": None})
    calls = (native.native_pad_events.calls, native.sqlite_fetch_f64.calls)
    got = list(DataLoader(_dataset(), batch_size=16, shuffle=True, seed=2))
    assert calls == (native.native_pad_events.calls,
                     native.sqlite_fetch_f64.calls)
    assert len(got) == len(exp) == 4
    for a, b in zip(got, exp):
        for x, y in zip(a.tensors().values(), b.tensors().values()):
            assert torch.equal(x, y)


def test_failed_compile_gives_none(monkeypatch, tmp_path):
    """A source that does not compile: ``get_lib`` is None (once a
    process), and nothing is left in the build directory."""
    monkeypatch.setattr(native, "HOST_SRC", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    (tmp_path / "collate.cpp").write_text("this is not C++\n")
    assert native.get_lib("collate") is None
    assert native._libs == {"collate": None}
    assert not native.library_path("collate").exists()
    assert not list(BUILD_DIR.glob(f"{native.library_path('collate').stem}*"))
    assert native.native_pad_events([np.ones((2, 3))], 4) is None


def test_counters_and_handles_under_thread_contention():
    """16 threads (more than the cores) with a short switch interval:
    no call is lost from the counters, the padding stays exact, and each
    thread's dataset handle is its own."""
    xs = _ragged(3)
    exp = pad_events(xs, length=64)
    ds = _dataset()
    calls = (native.native_pad_events.calls, native.sqlite_fetch_f64.calls)
    interval = sys.getswitchinterval()

    def work(_):
        handles = set()
        for _ in range(50):
            got = native.native_pad_events(xs, 64)
            assert all(np.array_equal(g, e) for g, e in zip(got, exp))
            handles.add(ds._native_handle())
        assert ds.get_batch_arrays([1, 2, 3]) is not None
        return handles

    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            per_thread = list(pool.map(work, range(16), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert native.native_pad_events.calls == calls[0] + 16 * 50
    assert native.sqlite_fetch_f64.calls == calls[1] + 16 * 2
    assert all(len(h) == 1 for h in per_thread)
    with pytest.raises(ValueError):
        native.native_pad_events([np.ones((2, 3)), np.ones((2, 4))], 4)
