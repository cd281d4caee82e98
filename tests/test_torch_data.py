"""The port's data path against the JAX package on the bundled Prometheus
SQLite database: ``SQLiteDataset`` with ``KNNGraph(Prometheus())``, the
``DataLoader`` batch for batch on both routes (and on a thread pool),
the datamodule's split, ``Trainer.fit`` from the loaders,
``predict_as_dataframe`` and the training example's command line."""

import os
import pickle
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from graphnet_tpu.data.constants import FEATURES as JAX_FEATURES
from graphnet_tpu.data.constants import TRUTH as JAX_TRUTH
from graphnet_tpu.data.dataloader import DataLoader as JaxDataLoader
from graphnet_tpu.data.datamodule import GraphNeTDataModule as JaxDataModule
from graphnet_tpu.data.sqlite_dataset import SQLiteDataset as JaxSQLiteDataset
from graphnet_tpu.models.detector.prometheus import Prometheus as JaxPrometheus
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models.graphs import KNNGraph as JaxKNNGraph
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    EnergyReconstruction as JaxEnergy,
)
from graphnet_tpu.training import loss_functions as jlf
from graphnet_tpu.training.trainer import Trainer as JaxTrainer
from graphnet_tpu.utils.config import TRANSFORM_REGISTRY
from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.datamodule import GraphNeTDataModule
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.graphs import KNNGraph
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
from graphnet_tpu_torch.ops.knn import knn_graph_plain
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(2)

ARGS = dict(pulsemaps="total", truth_table="mc_truth")
NARROW = dict(
    dynedge_layer_sizes=((16, 32), (24, 32)),
    post_processing_layer_sizes=(24, 16),
    readout_layer_sizes=(8,),
)


def double_pulses(event):
    """A custom label without a batched form: the loader takes the Event
    route."""
    return 2 * event.n_pulses


def _datasets(**kw):
    jax_ds = JaxSQLiteDataset(
        EXAMPLE_SQLITE_DATA, JaxKNNGraph(detector=JaxPrometheus()),
        features=JAX_FEATURES.PROMETHEUS, truth=JAX_TRUTH.PROMETHEUS,
        **ARGS, **kw)
    ds = SQLiteDataset(
        EXAMPLE_SQLITE_DATA, KNNGraph(detector=Prometheus()),
        features=FEATURES.PROMETHEUS, truth=TRUTH.PROMETHEUS, **ARGS, **kw)
    return jax_ds, ds


def _assert_same_batch(got, exp):
    exp = exp.unpacked()
    for name in ("x", "mask", "n_pulses"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(exp, name)), err_msg=name)
    assert set(got.labels) == set(exp.labels)
    for k, v in got.labels.items():
        e = np.asarray(exp.labels[k])
        assert v.numpy().dtype == e.dtype, k
        np.testing.assert_array_equal(v.numpy(), e, err_msg=k)


def test_dataset_matches_jax():
    """The same events: lengths, node arrays and labels of each."""
    jax_ds, ds = _datasets()
    assert len(ds) == len(jax_ds) == 50
    assert ds.event_lengths() == jax_ds.event_lengths()
    assert ds._features == jax_ds._features and ds._truth == jax_ds._truth
    for i in (0, 7, 49):
        got, exp = ds[i], jax_ds[i]
        np.testing.assert_array_equal(got.x, exp.x)
        assert got.features == exp.features
        assert set(got.labels) == set(exp.labels)
        for k in got.labels:
            np.testing.assert_array_equal(got.labels[k], exp.labels[k], err_msg=k)
    got = ds.get_batch_arrays([3, 1, 4])
    exp = jax_ds.get_batch_arrays([3, 1, 4])
    for a, b in zip(got[0], exp[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], exp[1])


def _string_ids():
    table = Prometheus().geometry_table
    return sorted(table["sensor_string_id"].unique().tolist())[:40]


@pytest.mark.parametrize("options", [
    dict(perturbation_dict={"sensor_pos_x": 0.1, "t": 10.0}, seed=7),
    dict(sort_by="t"),
    dict(repeat_labels=True),
    dict(string_mask="first 40 strings"),
    dict(add_inactive_sensors=True),
], ids=["perturbed", "sort_by_t", "repeat_labels", "string_mask",
        "inactive_sensors"])
def test_graph_definition_options_match_jax(options):
    """The Event route's per-event pipeline with each option of
    ``GraphDefinition``: the same node arrays, labels and node labels,
    and the same ``supports_batched``."""
    if options.get("string_mask") == "first 40 strings":
        options = dict(string_mask=_string_ids())
    jgd = JaxKNNGraph(detector=JaxPrometheus(), **options)
    tgd = KNNGraph(detector=Prometheus(), **options)
    assert tgd.supports_batched == jgd.supports_batched == ("sort_by" in options)
    jax_ds = JaxSQLiteDataset(EXAMPLE_SQLITE_DATA, jgd, features=JAX_FEATURES.PROMETHEUS,
                              truth=JAX_TRUTH.PROMETHEUS, **ARGS)
    ds = SQLiteDataset(EXAMPLE_SQLITE_DATA, tgd, features=FEATURES.PROMETHEUS,
                       truth=TRUTH.PROMETHEUS, **ARGS)
    for i in (0, 11):
        got, exp = ds[i], jax_ds[i]
        np.testing.assert_array_equal(got.x, exp.x)
        assert set(got.labels) == set(exp.labels)
        for k in got.labels:
            np.testing.assert_array_equal(got.labels[k], exp.labels[k], err_msg=k)
        assert set(got.node_labels) == set(exp.node_labels)
        for k in got.node_labels:
            np.testing.assert_array_equal(got.node_labels[k], exp.node_labels[k])
    if "sort_by" not in options:
        return
    feats = ds.get_batch_arrays([0, 11, 3])[0]
    for a, b in zip(tgd.build_x_batched(feats), jgd.build_x_batched(feats)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not in node features"):
        KNNGraph(detector=Prometheus(), sort_by="charge")


@pytest.mark.parametrize(
    "route,workers", [("batched", 0), ("events", 0), ("batched", 2)],
    ids=["batched", "events", "batched_2_threads"])
def test_dataloader_matches_jax_batch_for_batch(route, workers):
    """Shuffled, length-matched batches of 16 with ``buckets="auto:2"``:
    the same buckets, the same batches in the same order (x, mask,
    n_pulses, every label and its dtype), the same padding efficiency."""
    kw = {"labels": {"double_pulses": double_pulses}} if route == "events" else {}
    jax_ds, ds = _datasets(**kw)
    jl = JaxDataLoader(jax_ds, batch_size=16, shuffle=True, seed=3)
    tl = DataLoader(ds, batch_size=16, shuffle=True, seed=3, num_workers=workers)
    assert tl.buckets == jl.buckets and len(tl.buckets) == 2
    exp = list(jl)
    got = list(tl)
    assert len(got) == len(exp) == len(tl) == 4
    for g, e in zip(got, exp):
        _assert_same_batch(g, e)
    assert ("double_pulses" in got[0].labels) == (route == "events")
    assert tl._fast_ok == (route != "events")
    assert tl.padding_efficiency == pytest.approx(jl.padding_efficiency, rel=1e-12)


def test_dataloader_options():
    jax_ds, ds = _datasets()
    exp = list(JaxDataLoader(jax_ds, batch_size=16, buckets=(64, 128, 256),
                             length_matching=False, drop_last=True))
    got = list(DataLoader(ds, batch_size=16, buckets=(64, 128, 256),
                          length_matching=False, drop_last=True))
    assert len(got) == len(exp) == 3
    for g, e in zip(got, exp):
        _assert_same_batch(g, e)
    # stack_k groups batches of one shape (it raised before it was
    # ported; tests/test_torch_pipeline.py holds it to the JAX loader)
    stacked = list(DataLoader(ds, batch_size=16, buckets=(64, 128, 256),
                              length_matching=False, drop_last=True,
                              stack_k=2))
    assert [type(b).__name__ for b in stacked] == [
        "StackedBatches", "EventBatch"]
    for g, e in zip(stacked[0].unstack() + stacked[1:], exp):
        _assert_same_batch(g, e)
    # a string selection gives the JAX dataset's events; named selections
    # (a dict) belong in a dataset config
    selected = SQLiteDataset(
        EXAMPLE_SQLITE_DATA, KNNGraph(detector=Prometheus()),
        features=FEATURES.PROMETHEUS, truth=TRUTH.PROMETHEUS,
        selection="event_no % 5 > 0", **ARGS)
    jax_selected = JaxSQLiteDataset(
        EXAMPLE_SQLITE_DATA, JaxKNNGraph(detector=JaxPrometheus()),
        features=JAX_FEATURES.PROMETHEUS, truth=JAX_TRUTH.PROMETHEUS,
        selection="event_no % 5 > 0", **ARGS)
    assert selected._indices == jax_selected._indices
    assert 0 < len(selected) < len(ds)
    with pytest.raises(TypeError, match="load_dataset"):
        SQLiteDataset(EXAMPLE_SQLITE_DATA, KNNGraph(detector=Prometheus()),
                      features=FEATURES.PROMETHEUS, truth=TRUTH.PROMETHEUS,
                      selection={"train": "event_no % 5 > 0"}, **ARGS)


def test_datamodule_split_matches_jax():
    common = dict(path=EXAMPLE_SQLITE_DATA, **ARGS)
    jdm = JaxDataModule(JaxSQLiteDataset, dict(
        graph_definition=JaxKNNGraph(detector=JaxPrometheus()),
        features=JAX_FEATURES.PROMETHEUS, truth=JAX_TRUTH.PROMETHEUS, **common))
    tdm = GraphNeTDataModule(SQLiteDataset, dict(
        graph_definition=KNNGraph(detector=Prometheus()),
        features=FEATURES.PROMETHEUS, truth=TRUTH.PROMETHEUS, **common))
    assert tdm.train_dataset._indices == jdm.train_dataset._indices
    assert tdm.val_dataset._indices == jdm.val_dataset._indices
    assert len(tdm.val_dataset) == 5 and tdm.test_dataset is None
    assert tdm.train_dataloader().shuffle and not tdm.val_dataloader().shuffle


def _models():
    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4, global_pooling_schemes=("min", "max", "mean", "sum"),
                            **NARROW),
        tasks=(JaxEnergy(loss_function=jlf.LogCoshLoss(),
                         target_labels=("total_energy",),
                         transform_prediction_and_target=TRANSFORM_REGISTRY["log10"]),),
    )
    model = StandardModel(
        DynEdge(nb_inputs=4, global_pooling_schemes=("min", "max", "mean", "sum"),
                **NARROW),
        [EnergyReconstruction(hidden_size=8, loss_function=tlf.LogCoshLoss(),
                              target_labels=("total_energy",),
                              transform_prediction_and_target=torch.log10)],
        device="cpu",
    )
    return jmodel, model


class WithInputGraph:
    """A loader whose batches carry the port's kNN graph of their inputs
    (x, y, z, k=8) as ``edges``, which DynEdge then takes as its first
    adjacency.  The bundled detector is a grid: many pairs of pulses lie
    at exactly equal distances, and the JAX package's CPU kNN breaks
    such ties by its fp32 rounding (after centring, through a matrix
    product), not by the lower index; the port keeps the lower-index
    rule.  Both models get this one graph, so the comparison holds the
    training path, not the tie-breaking."""

    def __init__(self, loader, jax_batches):
        self.loader, self.jax_batches = loader, jax_batches

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for b in self.loader:
            x, mask = np.array(b.x), np.array(b.mask)
            idx, em = knn_graph_plain(torch.from_numpy(x[..., :3]),
                                      torch.from_numpy(mask), 8)
            if self.jax_batches:
                yield b.replace(edges=jax.numpy.asarray(idx.numpy()),
                                edge_mask=jax.numpy.asarray(em.numpy()))
            else:
                yield replace(b, edges=idx, edge_mask=em)


class JaxLatentGraphs:
    """The JAX model's latent kNN graphs, recorded in the order it builds
    them (``jax.debug.callback``, also under ``jit``), fed to the port's
    model in the same order in place of its own latent kNN.  The latents
    of the two frameworks differ in their last bits, and on this data
    many latent distances are near-ties that those bits decide: the two
    packages' latent graphs differ in many edges over the run,
    whichever package's kNN builds both.  So, as with the input graph
    (:class:`WithInputGraph`), both models get one graph, built from the
    JAX model's latents by the JAX package's kNN; the port's kNN is held
    to the JAX package's in ``tests/test_torch_ops.py``."""

    def __init__(self, monkeypatch):
        import graphnet_tpu.models.components.layers as jax_layers
        import graphnet_tpu_torch.models.components.layers as torch_layers

        self.jax_knn, self.graphs, self.used = jax_layers.knn_graph, [], 0
        monkeypatch.setattr(jax_layers, "knn_graph", self.record)
        monkeypatch.setattr(torch_layers, "knn_graph", self.replay)

    def record(self, coords, mask, k, exclude_self=True):
        idx, em = self.jax_knn(coords, mask, k=k, exclude_self=exclude_self)
        jax.debug.callback(
            lambda *g: self.graphs.append([np.array(a) for a in g]),
            idx, em, mask, ordered=True)
        return idx, em

    def replay(self, coords, mask, k, exclude_self=True):
        idx, em, jax_mask = self.graphs[self.used]
        self.used += 1
        assert np.array_equal(jax_mask, mask.numpy()) and idx.shape[-1] == k
        return torch.from_numpy(idx), torch.from_numpy(em)


def test_trainer_fit_and_predict_as_dataframe_match_jax(monkeypatch):
    """Two epochs from the loaders (train shuffled, validation not), the
    default schedule, from the same initial parameters, the input graph
    on the batches (:class:`WithInputGraph`) and the JAX model's latent
    graphs fed to both (:class:`JaxLatentGraphs`): losses within 1e-4, as
    ``tests/test_torch_training.py``; then the prediction frames of the
    validation loader, rtol 2e-4."""
    latent = JaxLatentGraphs(monkeypatch)
    jax_ds, ds = _datasets()
    jtrain = WithInputGraph(JaxDataLoader(jax_ds, batch_size=16, shuffle=True,
                                          seed=5), True)
    ttrain = WithInputGraph(DataLoader(ds, batch_size=16, shuffle=True, seed=5),
                            False)
    jval = WithInputGraph(JaxDataLoader(jax_ds, batch_size=32), True)
    tval = WithInputGraph(DataLoader(ds, batch_size=32), False)
    jmodel, model = _models()
    jtrainer = JaxTrainer(jmodel, learning_rate=1e-2)
    jtrainer.init(next(iter(jtrain)))
    params0 = jax.device_get(jtrainer.state.params)
    latent.graphs.clear()  # those of the JAX model's initialisation
    j_hist = jtrainer.fit(jtrain, jval, max_epochs=2)
    model.load_state_dict(params_from_jax(params0, model.state_dict()))
    trainer = Trainer(model, learning_rate=1e-2)
    hist = trainer.fit(ttrain, tval, max_epochs=2)
    assert trainer.step == 8
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], j_hist[key], rtol=1e-4, err_msg=key)

    exp = jtrainer.predict_as_dataframe(jval, additional_attributes=["total_energy"])
    got = trainer.predict_as_dataframe(tval, additional_attributes=["total_energy"])
    assert list(got.columns) == list(exp.columns) == ["energy_pred", "total_energy"]
    assert len(got) == 50
    np.testing.assert_allclose(got["energy_pred"], exp["energy_pred"], rtol=2e-4)
    np.testing.assert_array_equal(got["total_energy"], exp["total_energy"])
    assert latent.used == len(latent.graphs) > 0


def test_training_example_on_the_cpu(tmp_path, capsys):
    """``python -m graphnet_tpu_torch.examples.train_dynedge --device cpu
    --max-epochs 1``: a prediction frame, and a ``state_dict.pkl`` that
    loads into the same model; with the ``model.yml`` beside it, both
    packages' ``DeploymentModule`` serve the trained model alike."""
    from graphnet_tpu_torch.examples import train_dynedge

    out = tmp_path / "model"
    train_dynedge.main(["--device", "cpu", "--max-epochs", "1",
                        "--output", str(out)])
    printed = capsys.readouterr().out
    assert "energy_pred" in printed and "total_energy" in printed
    pkl = out / "state_dict.pkl"
    assert os.path.exists(pkl)
    with open(pkl, "rb") as f:
        assert "params" in pickle.load(f)
    args = train_dynedge.parse_args(["--device", "cpu"])
    assert train_dynedge.parse_args([]).device == "cuda"
    _, model = train_dynedge.build(args)
    Trainer(model).load_state_dict(str(pkl))
    from graphnet_tpu.deployment.deployment_module import (
        DeploymentModule as JaxDeploymentModule,
    )
    from graphnet_tpu.models.graphs.graph_definition import Event as JaxEvent
    from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
    from graphnet_tpu_torch.models.graphs.graph_definition import Event

    yml = str(out / "model.yml")
    arrays = [np.random.default_rng(0).standard_normal((n, 4)).astype(
        np.float32) for n in (12, 5)]
    got = DeploymentModule(yml, str(pkl), device="cpu")(
        [Event(x=a, features=FEATURES.PROMETHEUS) for a in arrays])
    exp = JaxDeploymentModule(yml, str(pkl))(
        [JaxEvent(x=a, features=FEATURES.PROMETHEUS) for a in arrays])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-5)


def test_training_example_seed_fixes_the_shuffle():
    """``--seed`` seeds the training loader's shuffle (none by default):
    two datamodules built with one seed give the same batches in the same
    order, another seed another order."""
    from graphnet_tpu_torch.examples import train_dynedge

    assert train_dynedge.parse_args([]).seed is None

    def first_batches(seed):
        dm, _ = train_dynedge.build(train_dynedge.parse_args(
            ["--device", "cpu", "--seed", str(seed)]))
        batches = iter(dm.train_dataloader())
        return [next(batches).labels["total_energy"] for _ in range(3)]

    a, b, c = first_batches(3), first_batches(3), first_batches(4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(x.shape == y.shape and torch.equal(x, y)
                   for x, y in zip(a, c))
