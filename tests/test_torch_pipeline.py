"""The port's input pipeline and Trainer feed against the JAX package on
the CPU: ``DataLoader(stack_k)`` batch for batch, ``Trainer(
steps_per_dispatch)`` against the JAX Trainer's steps on batches of two
lengths (with and without SWA) and against single steps in the JAX
step order, ``fit(prefetch=...)`` and the stacked route bit for bit,
the synthetic database row for row, the Parquet dataset event for event
and the ``training/utils.py`` splits."""

import os
import sqlite3
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from graphnet_tpu.batch import StackedBatches as JaxStackedBatches
from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.data.constants import FEATURES as JAX_FEATURES
from graphnet_tpu.data.constants import TRUTH as JAX_TRUTH
from graphnet_tpu.data.dataloader import DataLoader as JaxDataLoader
from graphnet_tpu.data.parquet_dataset import ParquetDataset as JaxParquetDataset
from graphnet_tpu.data.sqlite_dataset import SQLiteDataset as JaxSQLiteDataset
from graphnet_tpu.datasets.synthetic import (
    generate_prometheus_db as jax_generate_prometheus_db,
)
from graphnet_tpu.models.detector.prometheus import Prometheus as JaxPrometheus
from graphnet_tpu.models.graphs import KNNGraph as JaxKNNGraph
from graphnet_tpu.training import utils as jax_utils
from graphnet_tpu.training.trainer import Trainer as JaxTrainer
from graphnet_tpu_torch.batch import EventBatch, StackedBatches, make_batch
from graphnet_tpu_torch.constants import EXAMPLE_DATA_DIR, EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.parquet_dataset import ParquetDataset
from graphnet_tpu_torch.data.prefetch import CachingLoader
from graphnet_tpu_torch.data.samplers import RandomChunkSampler
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.datasets.synthetic import (
    cached_prometheus_db,
    generate_prometheus_db,
)
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.graphs import KNNGraph
from graphnet_tpu_torch.ops.knn import knn_graph_plain
from graphnet_tpu_torch.training import utils
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_data import JaxLatentGraphs, _models

torch.set_num_threads(2)

ARGS = dict(pulsemaps="total", truth_table="mc_truth")
PARQUET = os.path.join(EXAMPLE_DATA_DIR, "parquet", "prometheus", "merged")


def _datasets(path=EXAMPLE_SQLITE_DATA, jax_cls=JaxSQLiteDataset,
              cls=SQLiteDataset):
    jax_ds = jax_cls(path, JaxKNNGraph(detector=JaxPrometheus()),
                     features=JAX_FEATURES.PROMETHEUS,
                     truth=JAX_TRUTH.PROMETHEUS, **ARGS)
    ds = cls(path, KNNGraph(detector=Prometheus()),
             features=FEATURES.PROMETHEUS, truth=TRUTH.PROMETHEUS, **ARGS)
    return jax_ds, ds


def _assert_same(got: EventBatch, exp):
    """A port batch against a JAX one (unpacked): every tensor and dtype."""
    exp = exp.unpacked()
    for name in ("x", "mask", "n_pulses"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(exp, name)))
    assert set(got.labels) == set(exp.labels)
    for k, v in got.labels.items():
        e = np.asarray(exp.labels[k])
        assert v.numpy().dtype == e.dtype, k
        np.testing.assert_array_equal(v.numpy(), e, err_msg=k)


def test_stacked_loader_matches_jax():
    """``DataLoader(stack_k=3)`` on the bundled database, batches of 4 over
    two buckets: the same items in the same order as the JAX loader's
    (stacks, then each group's leftovers singly), each stack's batches
    equal to the JAX stack's after unpacking; ``len()`` counts batches."""
    jax_ds, ds = _datasets()
    exp = list(JaxDataLoader(jax_ds, batch_size=4, shuffle=True, seed=3,
                             stack_k=3))
    loader = DataLoader(ds, batch_size=4, shuffle=True, seed=3, stack_k=3)
    got = list(loader)
    assert len(loader) == 13 and len(got) == len(exp)
    assert [isinstance(g, StackedBatches) for g in got] == [
        isinstance(e, JaxStackedBatches) for e in exp]
    assert sum(isinstance(g, StackedBatches) for g in got) >= 2
    assert not isinstance(got[-1], StackedBatches)
    for g, e in zip(got, exp):
        if isinstance(g, StackedBatches):
            assert g.k == e.k == 3 and g.batch_size == e.batch_size
            assert g.batches.x.shape[0] == 3
            for gb, eb in zip(g.unstack(), e.unstack()):
                _assert_same(gb, eb)
        else:
            _assert_same(g, e)
    flat = [b for g in got for b in (g.unstack() if isinstance(
        g, StackedBatches) else [g])]
    assert len(flat) == 13


# ------------------------------------------------- steps_per_dispatch
LENGTHS = (16, 32, 16, 16, 32, 32, 16)  # two buckets, 7 batches of 4
JAX_ORDER = (0, 2, 3, 1, 4, 5, 6)  # groups of 3 by shape, leftovers last


def _two_length_batches(seed=0):
    """Seven batches of four events at L = 16 or 32 (numpy from a seed),
    each with the port's kNN graph of its inputs as ``edges``, for both
    packages (``tests/test_torch_data.py::WithInputGraph``)."""
    rng = np.random.default_rng(seed)
    port, jax_batches = [], []
    for L in LENGTHS:
        events = [rng.standard_normal((int(rng.integers(L // 2 + 1, L + 1)), 4))
                  .astype(np.float32) for _ in range(4)]
        labels = {"total_energy": rng.uniform(10, 1000, 4).astype(np.float32)}
        b = make_batch(events, labels=labels, length=L)
        idx, em = knn_graph_plain(b.x[..., :3], b.mask, 8)
        port.append(replace(b, edges=idx, edge_mask=em))
        jb = jax_make_batch(events, labels=labels, length=L)
        jax_batches.append(jb.replace(edges=jax.numpy.asarray(idx.numpy()),
                                      edge_mask=jax.numpy.asarray(em.numpy())))
    return port, jax_batches


@pytest.mark.parametrize("averaging", [None, "swa"])
def test_steps_per_dispatch_matches_jax(monkeypatch, averaging):
    """``Trainer(steps_per_dispatch=3)`` and the JAX Trainer's
    ``lax.scan`` route from the same initial parameters, two epochs of
    seven batches of two lengths, the JAX model's latent graphs fed to
    the port's (``JaxLatentGraphs``): per-epoch losses within 1e-4, and
    with SWA the averaged model's predictions within 2e-4."""
    latent = JaxLatentGraphs(monkeypatch)
    port_batches, jax_batches = _two_length_batches()
    jmodel, model = _models()
    jtrainer = JaxTrainer(jmodel, learning_rate=1e-2, steps_per_dispatch=3,
                          averaging=averaging)
    jtrainer.init(jax_batches[0])
    params0 = jax.device_get(jtrainer.state.params)
    latent.graphs.clear()
    j_hist = jtrainer.fit(jax_batches, max_epochs=2)
    model.load_state_dict(params_from_jax(params0, model.state_dict()))
    trainer = Trainer(model, learning_rate=1e-2, steps_per_dispatch=3,
                      averaging=averaging)
    hist = trainer.fit(port_batches, max_epochs=2)
    assert trainer.step == jtrainer.state.step == 14
    assert latent.used == len(latent.graphs) > 0
    np.testing.assert_allclose(hist["train_loss"], j_hist["train_loss"],
                               rtol=1e-4)
    if averaging:  # the JAX forwards record the graphs the port's replay
        exp = np.concatenate(jtrainer.predict(jax_batches[:2]))
        got = np.concatenate(trainer.predict(port_batches[:2]))
        np.testing.assert_allclose(got, exp, rtol=2e-4)


def _fit(batches, spd=1, averaging=None, seed=1, **fit_kw):
    _, model = _models()
    torch.manual_seed(0)
    trainer = Trainer(model, learning_rate=1e-2, steps_per_dispatch=spd,
                      averaging=averaging, seed=seed)
    losses = []
    inner = trainer.train_step

    def recording(b):
        loss = inner(b)
        losses.append(loss)
        return loss

    trainer.train_step = recording
    hist = trainer.fit(batches, max_epochs=2, **fit_kw)
    return (torch.stack(losses), hist["train_loss"],
            {k: v.clone() for k, v in model.state_dict().items()})


def _same(a, b):
    assert torch.equal(a[0], b[0])
    assert a[1] == b[1]
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


@pytest.mark.parametrize("averaging", [None, "ema"])
def test_steps_per_dispatch_is_single_steps_in_the_jax_order(averaging):
    """The port with ``steps_per_dispatch=3`` is bit for bit the port with
    one step a batch fed the batches in the JAX Trainer's order (each
    step its own generator seed, schedule step and average update)."""
    batches, _ = _two_length_batches(seed=1)
    grouped = _fit(batches, spd=3, averaging=averaging)
    ordered = _fit([batches[i] for i in JAX_ORDER], averaging=averaging)
    _same(grouped, ordered)
    assert not torch.equal(grouped[0], _fit(batches, averaging=averaging)[0])


def _sqlite_loader(**kw):
    return DataLoader(_datasets()[1], batch_size=4, shuffle=True, seed=2, **kw)


@pytest.mark.parametrize("route", ["prefetch", "stacked", "cached"])
def test_pipelines_are_bit_for_bit_the_plain_loader(route):
    """Two epochs of ``steps_per_dispatch=3`` from the bundled database:
    with ``fit(prefetch=2)``, with ``DataLoader(stack_k=3)`` and
    ``prefetch=2`` (the stacks copied at once, then stepped as views),
    and a ``CachingLoader(store="host")`` with and without the pipeline
    (its epoch forwarded by the pipeline's producer): the same losses and
    parameters, bit for bit."""
    if route == "cached":
        plain = _fit(CachingLoader(_sqlite_loader(), store="host",
                                   device="cpu"), spd=3)
        got = _fit(CachingLoader(_sqlite_loader(), store="host",
                                 device="cpu"), spd=3, prefetch=2)
    else:
        plain = _fit(_sqlite_loader(), spd=3)
        stack_k = 3 if route == "stacked" else 0
        got = _fit(_sqlite_loader(stack_k=stack_k), spd=3, prefetch=2)
    _same(got, plain)
    assert len(got[0]) == 26


# ------------------------------------------------------ data sources
def test_synthetic_database_matches_jax(tmp_path):
    port = generate_prometheus_db(str(tmp_path / "port.db"), n_events=40,
                                  seed=5)
    jax_db = jax_generate_prometheus_db(str(tmp_path / "jax.db"),
                                        n_events=40, seed=5)
    a, b = sqlite3.connect(port), sqlite3.connect(jax_db)
    try:
        for sql in ("SELECT sql FROM sqlite_master ORDER BY name",
                    "SELECT * FROM total", "SELECT * FROM mc_truth"):
            assert a.execute(sql).fetchall() == b.execute(sql).fetchall(), sql
    finally:
        a.close()
        b.close()
    path = cached_prometheus_db(40, seed=5, cache_dir=str(tmp_path))
    assert path == cached_prometheus_db(40, seed=5, cache_dir=str(tmp_path))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_parquet_dataset_matches_jax():
    """Every event of the bundled Parquet data (pyarrow in the port,
    pandas in the JAX package): lengths, node arrays, labels and dtypes;
    a chunk selection; the chunk sampler's order."""
    jax_ds, ds = _datasets(PARQUET, JaxParquetDataset, ParquetDataset)
    assert len(ds) == len(jax_ds) == 50
    assert ds.chunk_sizes == jax_ds.chunk_sizes
    assert ds.event_lengths() == jax_ds.event_lengths()
    assert ds._features == jax_ds._features and ds._truth == jax_ds._truth
    for i in range(len(ds)):
        got, exp = ds[i], jax_ds[i]
        np.testing.assert_array_equal(got.x, exp.x)
        assert set(got.labels) == set(exp.labels)
        for k in got.labels:
            g, e = np.asarray(got.labels[k]), np.asarray(exp.labels[k])
            assert g.dtype == e.dtype, k
            np.testing.assert_array_equal(g, e, err_msg=k)
    for table, cols in (("total", ["t", "sensor_id"]),
                        ("mc_truth", ["event_no", "total_energy"])):
        np.testing.assert_array_equal(ds.query_table(table, cols),
                                      jax_ds.query_table(table, cols))
    sub = ParquetDataset(PARQUET, KNNGraph(detector=Prometheus()),
                         features=FEATURES.PROMETHEUS, truth=TRUTH.PROMETHEUS,
                         selection=[7, 2], cache_size=2, **ARGS)
    assert len(sub) == ds.chunk_sizes[7] + ds.chunk_sizes[2]
    np.testing.assert_array_equal(sub[0].x, ds[sum(ds.chunk_sizes[:7])].x)
    from graphnet_tpu.data.samplers import RandomChunkSampler as JaxSampler

    assert list(RandomChunkSampler(ds.chunk_sizes, seed=4)) == list(
        JaxSampler(ds.chunk_sizes, seed=4))
    batches = list(DataLoader(ds, batch_size=16, shuffle=True, seed=1))
    exp = list(JaxDataLoader(jax_ds, batch_size=16, shuffle=True, seed=1))
    assert len(batches) == len(exp) == 4
    for g, e in zip(batches, exp):
        _assert_same(g, e)


def test_training_utils_match_jax(tmp_path):
    """``make_train_validation_dataloader`` on SQLite and Parquet: the
    same selections as the JAX package's; ``make_dataloader``'s labels;
    ``save_selection``."""
    common = dict(pulsemaps="total", truth_table="mc_truth", batch_size=8)
    for db in (PARQUET, EXAMPLE_SQLITE_DATA):
        train, val = utils.make_train_validation_dataloader(
            db, KNNGraph(detector=Prometheus()), None,
            features=FEATURES.PROMETHEUS, truth=TRUTH.PROMETHEUS,
            test_size=0.2, seed=3, **common)
        jtrain, jval = jax_utils.make_train_validation_dataloader(
            db, JaxKNNGraph(detector=JaxPrometheus()), None,
            features=JAX_FEATURES.PROMETHEUS, truth=JAX_TRUTH.PROMETHEUS,
            test_size=0.2, seed=3, **common)
        assert type(train.dataset).__name__ == type(jtrain.dataset).__name__
        assert train.dataset._indices == jtrain.dataset._indices
        assert val.dataset._indices == jval.dataset._indices
        assert train.shuffle and not val.shuffle and train.seed == 3
    loader = utils.make_dataloader(
        EXAMPLE_SQLITE_DATA, "total", KNNGraph(detector=Prometheus()),
        FEATURES.PROMETHEUS, TRUTH.PROMETHEUS, batch_size=8, shuffle=False,
        truth_table="mc_truth", selection=train.dataset._indices[:3],
        labels={"twice": lambda e: 2 * e.n_pulses})
    batch = next(iter(loader))
    assert batch.batch_size == 3
    torch.testing.assert_close(batch.labels["twice"], 2 * batch.n_pulses,
                               check_dtype=False)
    path = tmp_path / "sel.csv"
    utils.save_selection([3, 1, 4], str(path))
    jax_utils.save_selection([3, 1, 4], str(tmp_path / "jax.csv"))
    assert path.read_text() == (tmp_path / "jax.csv").read_text() == "3,1,4\n"
    with pytest.raises(TypeError):
        utils.save_selection((3, 1), str(path))
