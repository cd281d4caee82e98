"""The port's curated datasets against the JAX package's on the CPU:
``TestDataset``'s metadata and description, its loaders' first batches
on both backends, the feature subset, the backend and feature checks,
the download gate of a missing ``dataset_dir`` and the hosted download
through a ``file://`` mirror (no network), and the public Prometheus
datasets' declarations."""

import os
import shutil
import tarfile

import numpy as np
import pytest

from graphnet_tpu.data.curated_datamodule import (
    CuratedDataset as JaxCuratedDataset,
)
from graphnet_tpu.datasets import prometheus_datasets as jpd
from graphnet_tpu.datasets.test_dataset import TestDataset as JaxTestDataset
from graphnet_tpu.models.detector.prometheus import Prometheus as JaxPrometheus
from graphnet_tpu.models.graphs import KNNGraph as JaxKNNGraph
from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.curated_datamodule import CuratedDataset
from graphnet_tpu_torch.data.parquet_dataset import ParquetDataset
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.datasets import prometheus_datasets as tpd
from graphnet_tpu_torch.datasets.test_dataset import TestDataset as PortTestDataset
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.graphs import KNNGraph
from tests.test_torch_data import _assert_same_batch

LOADERS = dict(train_dataloader_kwargs={"batch_size": 8, "seed": 0},
               validation_dataloader_kwargs={"batch_size": 8},
               test_dataloader_kwargs={"batch_size": 8})


def _pair(**kw):
    """The JAX and the port ``TestDataset`` with the same arguments."""
    jax_kw = dict(kw)
    if "graph" in jax_kw:
        graph_kw = jax_kw.pop("graph")
        kw.pop("graph")
        jgraph = JaxKNNGraph(detector=JaxPrometheus(), **graph_kw)
        tgraph = KNNGraph(detector=Prometheus(), **graph_kw)
    else:
        jgraph = JaxKNNGraph(detector=JaxPrometheus())
        tgraph = KNNGraph(detector=Prometheus())
    return (JaxTestDataset(jgraph, **LOADERS, **jax_kw),
            PortTestDataset(tgraph, **LOADERS, **kw))


def test_metadata_and_description_match_jax(capsys):
    jds, tds = _pair()
    for attr in ("pulsemaps", "truth_table", "event_truth", "features",
                 "experiment", "citation", "dataset_dir"):
        assert getattr(tds, attr) == getattr(jds, attr), attr
    assert tds.pulsemaps == ["total"] and tds.truth_table == "mc_truth"
    assert "total_energy" in tds.event_truth and tds.citation is None
    jds.description()
    exp = capsys.readouterr().out
    tds.description()
    got = capsys.readouterr().out
    assert got == exp and "50-event" in got and "TestDataset" in got


@pytest.mark.parametrize("backend", ["sqlite", "parquet"])
def test_loaders_match_jax(backend):
    """The split's sizes, and the first batch of the train and the
    validation loaders, batch for batch the JAX package's."""
    jds, tds = _pair(backend=backend)
    cls = SQLiteDataset if backend == "sqlite" else ParquetDataset
    assert isinstance(tds.train_dataset, cls)
    assert len(tds.train_dataset) == len(jds.train_dataset) == 45
    assert len(tds.val_dataset) == len(jds.val_dataset) == 5
    for loader in ("train_dataloader", "val_dataloader"):
        got = next(iter(getattr(tds, loader)()))
        exp = next(iter(getattr(jds, loader)()))
        assert got.batch_size == (8 if loader == "train_dataloader" else 5)
        assert np.isfinite(got.x.numpy()).all()
        _assert_same_batch(got, exp)


def test_feature_subset_and_checks_match_jax():
    """A subset of the features with a graph for it; an unknown feature
    and an unknown backend raise as in the JAX package."""
    subset = ["sensor_pos_x", "sensor_pos_y", "t"]
    jds, tds = _pair(features=subset, graph=dict(input_feature_names=subset,
                                                 columns=(0, 1)))
    got, exp = next(iter(tds.train_dataloader())), next(iter(jds.train_dataloader()))
    assert got.x.shape[-1] == 3
    _assert_same_batch(got, exp)
    for cls, graph in ((PortTestDataset, KNNGraph(detector=Prometheus())),
                       (JaxTestDataset, JaxKNNGraph(detector=JaxPrometheus()))):
        with pytest.raises(AssertionError, match="unknown features"):
            cls(graph, features=["not_a_feature"])
        with pytest.raises(AssertionError, match="backend"):
            cls(graph, backend="hdf5")


def test_download_gate_raises_as_jax(tmp_path):
    """A curated dataset whose ``dataset_dir`` is missing and which has
    no download raises the JAX package's error."""
    messages = []
    for base, graph in ((CuratedDataset, KNNGraph(detector=Prometheus())),
                        (JaxCuratedDataset, JaxKNNGraph(detector=JaxPrometheus()))):
        class Hosted(base):
            _pulsemaps = ["total"]
            _features = ["t"]
            _event_truth = ["e"]

            def _prepare_args(self, backend, features, truth):
                return {}, None, None

        with pytest.raises(RuntimeError, match="no network") as err:
            Hosted(graph_definition=graph,
                   download_dir=str(tmp_path / "nonexistent"))
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def _mirror(tmp_path):
    """A sharelink-style archive (no suffix) of a copy of the bundled
    database under a ``file://`` mirror."""
    payload = tmp_path / "payload"
    payload.mkdir()
    shutil.copy(EXAMPLE_SQLITE_DATA, payload / "prometheus-events.db")
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    with tarfile.open(str(mirror / "ABC123"), "w:gz") as tf:
        tf.add(str(payload / "prometheus-events.db"),
               arcname="prometheus-events.db")
    return mirror


def test_hosted_download_matches_jax(tmp_path):
    """``PublicPrometheusDataset`` through a ``file://`` mirror: download,
    extraction into ``<download_dir>/<class>``, the dataset and its first
    batch as the JAX package's; a second build reuses the files; a bad
    mirror raises as in the JAX package."""
    mirror = _mirror(tmp_path)
    batches, messages = [], []
    for name, mod, graph in (
            ("port", tpd, KNNGraph(detector=Prometheus())),
            ("jax", jpd, JaxKNNGraph(detector=JaxPrometheus()))):
        class BundledHosted(mod.PublicPrometheusDataset):
            _experiment = "file:// fixture"
            _mirror = f"file://{mirror}"
            _file_hashes = {"sqlite": "ABC123"}
            _pulsemaps = ["total"]
            _event_truth = ["total_energy", "injection_zenith"]

        ds = BundledHosted(graph_definition=graph,
                           download_dir=str(tmp_path / name), **LOADERS)
        assert os.listdir(ds.dataset_dir) == ["prometheus-events.db"]
        assert ds.dataset_dir == str(tmp_path / name / "BundledHosted")
        batches.append(next(iter(ds.train_dataloader())))
        again = BundledHosted(graph_definition=graph,
                              download_dir=str(tmp_path / name), **LOADERS)
        assert os.listdir(again.dataset_dir) == ["prometheus-events.db"]

        class Broken(mod.PublicPrometheusDataset):
            _mirror = f"file://{tmp_path}/void"
            _file_hashes = {"sqlite": "NOPE"}

        with pytest.raises(RuntimeError, match="could not download") as err:
            Broken(graph_definition=graph,
                   download_dir=str(tmp_path / f"broken_{name}"))
        messages.append(str(err.value).replace(f"broken_{name}", "broken"))
    _assert_same_batch(batches[0], batches[1])
    assert messages[0] == messages[1]


def test_public_datasets_match_jax():
    """The public Prometheus datasets' declarations: the JAX package's."""
    for name in ("PublicPrometheusDataset", "TRIDENTSmall", "PONESmall",
                 "BaikalGVDSmall"):
        got, exp = getattr(tpd, name), getattr(jpd, name)
        for attr in ("_pulsemaps", "_truth_table", "_event_truth", "_features",
                     "_experiment", "_creator", "_comments", "_citation",
                     "_file_hashes", "_mirror", "_available_backends"):
            assert getattr(got, attr) == getattr(exp, attr), (name, attr)
