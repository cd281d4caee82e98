"""The port's GraphNeT checkpoint and config porters
(``graphnet_tpu_torch/utils/weight_port.py``) against the JAX package's
on the CPU.  The checkpoints come from the JAX tests' torch models in
GraphNeT's key layout (``tests/test_weight_port.py``: DynEdge and TITO;
``tests/test_weight_port_deepice.py``: DeepIce plain and scaled with the
nested DynEdge): each port porter gives exactly ``params_from_jax`` of
the JAX porter's tree, and the port model with it reproduces the torch
model's activations at the JAX tests' tolerances; so do the porters of
DynEdgeJINST, ConvNet (both PyG bias layouts) and ParticleNeT on the
torch models of ``tests/test_weight_port_more.py``.  Missing, unused and
mis-shaped keys raise in both; the GraphNeT config translations build the
same configs and datasets; the stand-in checkpoints of
``examples/port_pretrained.py`` (the chip run's) have GraphNeT's layout
for every backbone, ISeeCube and RNN_TITO included; the five backbones
that were unported port from GraphNeT configs; the example serves what
the JAX example's porter serves."""

import pickle

import numpy as np
import pytest
import torch
import yaml

import jax

import graphnet_tpu.utils.config as jconfig
import graphnet_tpu.utils.weight_port as jport
import tests.test_weight_port as jw
import tests.test_weight_port_deepice as jwd
import tests.test_weight_port_more as jwm
from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.data.sqlite_dataset import SQLiteDataset as JaxSQLiteDataset
from graphnet_tpu.deployment.deployment_module import (
    DeploymentModule as JaxDeploymentModule,
)
from graphnet_tpu.models.gnn.convnet import ConvNet as JaxConvNet
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models.gnn.dynedge_jinst import DynEdgeJINST as JaxJINST
from graphnet_tpu.models.gnn.dynedge_kaggle_tito import (
    DynEdgeTITO as JaxDynEdgeTITO,
)
from graphnet_tpu.models.gnn.icemix import DeepIce as JaxDeepIce
from graphnet_tpu.models.gnn.particlenet import ParticleNeT as JaxParticleNeT
from graphnet_tpu.models.gnn.rnn_tito import RNNTITO as JaxRNNTITO
from graphnet_tpu.models.transformer.iseecube import ISeeCube as JaxISeeCube
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.task import IdentityTask as JaxIdentityTask
from graphnet_tpu.training.loss_functions import LogCoshLoss as JaxLogCosh
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataset import EnsembleDataset
from graphnet_tpu_torch.examples import port_pretrained
from graphnet_tpu_torch.examples.port_pretrained import graphnet_state_dict
from graphnet_tpu_torch.utils import config
from graphnet_tpu_torch.utils import weight_port as tport
from graphnet_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(2)

TITO = jw.TestPortTITO()


def _port_model(jmodel):
    """The port model of a JAX model's config, on the CPU."""
    return config.build(config.ModelConfig.from_dict(
        jconfig.capture_config(jmodel).as_dict()), seed=0, device="cpu")


def _assert_same_state(got, exp):
    assert sorted(got) == sorted(exp)
    for k in exp:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], exp[k]), k


def _predict(model, xs):
    with torch.no_grad():
        return model(make_batch(list(xs), length=xs.shape[1]))[0][0].numpy()


# ------------------------------------------------------------ DynEdge
def _dynedge_case():
    tmodel = jw._torch_reference_model()
    xs = np.random.default_rng(0).standard_normal(
        (jw.B, jw.L, jw.D)).astype(np.float32) * 2.0
    jmodel = jw._flax_model()
    template = jmodel.init(jax.random.PRNGKey(0),
                           jax_make_batch(list(xs), length=jw.L))
    return tmodel, xs, jmodel, template


def test_dynedge_porter_equals_jax_and_reproduces_torch():
    tmodel, xs, jmodel, template = _dynedge_case()
    params = jport.port_dynedge_state_dict(tmodel.state_dict(), template)
    model = _port_model(jmodel)
    sd = tport.port_dynedge_state_dict(tmodel.state_dict(), model.state_dict())
    _assert_same_state(sd, params_from_jax(jax.device_get(params),
                                           model.state_dict()))
    model.load_state_dict(sd)
    with torch.no_grad():
        golden = jw._torch_forward(tmodel, torch.from_numpy(xs))["task_0"]
    np.testing.assert_allclose(_predict(model, xs), golden.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_dynedge_porter_reads_a_skipped_readout():
    """A ``skip_readout`` backbone has no readout, but GraphNeT's
    checkpoint carries ``_readout``: both porters read and drop it."""
    tmodel, xs, _, _ = _dynedge_case()
    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=jw.D, skip_readout=True),
        tasks=(JaxIdentityTask(nb_outputs=1, loss_function=JaxLogCosh(),
                               target_labels=("total_energy",),
                               node_level=True),))
    template = jmodel.init(jax.random.PRNGKey(0),
                           jax_make_batch(list(xs), length=jw.L))
    sd = {k: v for k, v in tmodel.state_dict().items() if "_tasks" not in k}
    sd["_tasks.0._affine.weight"] = torch.randn(1, jw.POST[-1])
    sd["_tasks.0._affine.bias"] = torch.randn(1)
    params = jport.port_dynedge_state_dict(sd, template)
    model = _port_model(jmodel)
    got = tport.port_dynedge_state_dict(sd, model.state_dict())
    _assert_same_state(got, params_from_jax(jax.device_get(params),
                                            model.state_dict()))
    assert not any("readout" in k for k in got)


# --------------------------------------------------------------- TITO
def test_tito_porter_equals_jax_and_reproduces_torch():
    tmodel = TITO._torch_tito()
    xs = np.random.default_rng(1).standard_normal(
        (3, TITO.L2, 4)).astype(np.float32) * 2.0
    with torch.no_grad():
        golden = TITO._torch_forward(tmodel, torch.from_numpy(xs)).numpy()
    jmodel = JaxStandardModel(
        backbone=JaxDynEdgeTITO(nb_inputs=4),
        tasks=(JaxIdentityTask(nb_outputs=1, loss_function=JaxLogCosh(),
                               target_labels=("total_energy",)),))
    template = jmodel.init(jax.random.PRNGKey(0),
                           jax_make_batch(list(xs), length=TITO.L2))
    params = jport.port_tito_state_dict(tmodel.state_dict(), template)
    model = _port_model(jmodel)
    sd = tport.port_tito_state_dict(tmodel.state_dict(), model.state_dict())
    _assert_same_state(sd, params_from_jax(jax.device_get(params),
                                           model.state_dict()))
    model.load_state_dict(sd)
    np.testing.assert_allclose(_predict(model.eval(), xs), golden,
                               rtol=5e-3, atol=5e-3)


# ------------------------------------------------------------- DeepIce
@pytest.mark.parametrize("scaled,include_dynedge", [(False, False), (True, True)],
                         ids=["plain", "scaled+dynedge"])
def test_deepice_porter_equals_jax_and_reproduces_torch(scaled, include_dynedge):
    torch.manual_seed(0)
    tmodel = jwd._ModelSim(scaled=scaled, include_dynedge=include_dynedge)
    rng = np.random.default_rng(0)
    xs = 2.0 * rng.standard_normal((jwd.B, jwd.L, jwd.F)).astype(np.float32)
    xs[:, :, 5] = (xs[:, :, 5] > 0).astype(np.float32)
    with torch.no_grad():
        golden = tmodel(torch.from_numpy(xs)).numpy()
    jmodel = jwd._flax_model(scaled, include_dynedge)
    template = jmodel.init(jax.random.PRNGKey(0),
                           jax_make_batch(list(xs), length=jwd.L))
    params = jport.port_deepice_state_dict(tmodel.state_dict(), template)
    model = _port_model(jmodel)
    sd = tport.port_deepice_state_dict(tmodel.state_dict(), model.state_dict())
    _assert_same_state(sd, params_from_jax(jax.device_get(params),
                                           model.state_dict()))
    assert any(k.startswith("backbone.dyn_edge.") for k in sd) == include_dynedge
    # the checkpoint has no q/v biases (GraphNeT's qkv_bias=False): zeros
    assert not sd["backbone.sandwich_0.attn.proj_q.bias"].any()
    model.load_state_dict(sd)
    np.testing.assert_allclose(_predict(model, xs), golden, rtol=2e-3,
                               atol=2e-3)


# ------------------------------------- JINST, ConvNet, ParticleNeT
def _more_case(kind):
    """``(torch model, its state_dict, golden, inputs, JAX model, JAX
    porter)`` of a ``tests/test_weight_port_more.py`` case; ConvNet's
    ``single_bias`` the older PyG layout (bias-free ``lins``, one module
    bias)."""
    xs = jwm._inputs({"jinst": 3, "convnet": 4, "convnet_single_bias": 5,
                      "particlenet": 6}[kind])
    if kind == "jinst":
        case = jwm.TestPortJINST()
        backbone = JaxJINST(nb_inputs=jwm.D, layer_size_scale=case.C)
        jporter = jport.port_jinst_state_dict
    elif kind.startswith("convnet"):
        case = jwm.TestPortConvNet()
        backbone = JaxConvNet(nb_inputs=jwm.D, nb_outputs_=case.NO,
                              nb_intermediate=case.NI, frozen_batchnorm=True)
        jporter = jport.port_convnet_state_dict
    else:
        case = jwm.TestPortParticleNeT()
        backbone = JaxParticleNeT(
            nb_inputs=jwm.D, nb_neighbours=jwm.K,
            dynedge_layer_sizes=case.SIZES,
            readout_layer_sizes=case.READOUT,
            global_pooling_schemes=("mean",), frozen_batchnorm=True)
        jporter = jport.port_particlenet_state_dict
    tmodel = case._torch_model(seed=7 if kind == "convnet_single_bias" else 0)
    sd = dict(tmodel.state_dict())
    if kind == "convnet_single_bias":
        for k in [k for k in sd if ".lins." in k and k.endswith(".bias")]:
            root = k.split(".lins.")[0]
            sd[f"{root}.bias"] = sd.get(f"{root}.bias", 0) + sd.pop(k)
    with torch.no_grad():
        golden = case._torch_forward(tmodel, torch.from_numpy(xs)).numpy()
    jmodel = JaxStandardModel(backbone=backbone,
                              tasks=(jwm._task(0),))
    return sd, golden, xs, jmodel, jporter


@pytest.mark.parametrize("kind", ["jinst", "convnet", "convnet_single_bias",
                                  "particlenet"])
def test_more_porters_equal_jax_and_reproduce_torch(kind):
    """The porters of DynEdgeJINST, ConvNet and ParticleNeT on the JAX
    tests' GraphNeT-layout torch models: ``params_from_jax`` of the JAX
    porter's tree leaf for leaf, and the torch model's activations (eval
    mode: the batch norms' running statistics into the frozen ones) at
    the JAX tests' tolerance."""
    sd, golden, xs, jmodel, jporter = _more_case(kind)
    template = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                              jax_make_batch(list(xs), length=jwm.L))
    params = jporter(sd, template)
    model = _port_model(jmodel)
    got = tport.port_state_dict(model, sd)
    _assert_same_state(got, params_from_jax(jax.device_get(params),
                                            model.state_dict()))
    model.load_state_dict(got)
    np.testing.assert_allclose(_predict(model, xs), golden, rtol=5e-3,
                               atol=5e-3)


def test_batch_norm_statistics_without_frozen_ones_warn_in_both():
    """A checkpoint's running statistics and a model without frozen ones
    (batch statistics): both porters warn, and port the rest."""
    sd, _, xs, jmodel, _ = _more_case("particlenet")
    jmodel = jmodel.clone(backbone=jmodel.backbone.clone(
        frozen_batchnorm=False))
    template = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                              jax_make_batch(list(xs), length=jwm.L))
    with pytest.warns(UserWarning, match="running statistics"):
        params = jport.port_particlenet_state_dict(sd, template)
    model = _port_model(jmodel)
    with pytest.warns(UserWarning, match="running statistics"):
        got = tport.port_state_dict(model, sd)
    _assert_same_state(got, params_from_jax(jax.device_get(params),
                                            model.state_dict()))


# -------------------------------------------------------------- errors
def _faults():
    tmodel, _, jmodel, template = _dynedge_case()
    return dict(tmodel.state_dict()), template, _port_model(jmodel)


def test_missing_key_raises_in_both():
    sd, template, model = _faults()
    del sd["backbone._conv_layers.2.nn.2.bias"]
    with pytest.raises(KeyError, match="_conv_layers.2.nn.2.bias"):
        jport.port_dynedge_state_dict(sd, template)
    with pytest.raises(KeyError, match="_conv_layers.2.nn.2.bias"):
        tport.port_dynedge_state_dict(sd, model.state_dict())


def test_unused_key_raises_in_both():
    sd, template, model = _faults()
    sd["backbone.stray.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="unported.*backbone.stray.weight"):
        jport.port_dynedge_state_dict(sd, template)
    with pytest.raises(ValueError, match="unported.*backbone.stray.weight"):
        tport.port_dynedge_state_dict(sd, model.state_dict())


def test_mis_shaped_key_raises_in_both():
    """The JAX package asserts (AssertionError); the port raises
    ValueError (an assert is stripped under ``python -O``); both say
    "shape mismatch"."""
    sd, template, model = _faults()
    sd["backbone._post_processing.2.weight"] = torch.zeros(256, 335)
    with pytest.raises(AssertionError, match="shape mismatch"):
        jport.port_dynedge_state_dict(sd, template)
    with pytest.raises(ValueError, match="shape mismatch"):
        tport.port_dynedge_state_dict(sd, model.state_dict())


def test_deepice_stray_key_raises_in_both():
    torch.manual_seed(0)
    tmodel = jwd._ModelSim()
    jmodel = jwd._flax_model(False, False)
    xs = np.zeros((jwd.B, jwd.L, jwd.F), np.float32)
    template = jmodel.init(jax.random.PRNGKey(0),
                           jax_make_batch(list(xs), length=jwd.L))
    sd = dict(tmodel.state_dict())
    sd["backbone.stray.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="unported"):
        jport.port_deepice_state_dict(sd, template)
    with pytest.raises(ValueError, match="unported"):
        tport.port_deepice_state_dict(sd, _port_model(jmodel).state_dict())


# ------------------------------------------------- config translation
def _queso_like(tmp_path):
    path = str(tmp_path / "queso_like.yml")
    jw.TestReferenceConfigTranslation()._write_queso_like_config(path)
    return path


def test_from_reference_config_builds_the_jax_config(tmp_path):
    """The JAX test's QUESO-like GraphNeT config: the same model and graph
    definition configs in both packages, the transforms resolved from the
    registry (never evaluated), the model on the device asked for."""
    path = _queso_like(tmp_path)
    model, gd = tport.from_reference_config(path, device="cpu")
    jmodel, jgd = jport.from_reference_config(path)
    assert next(model.parameters()).device.type == "cpu"
    assert (config.capture_config(model).as_dict()
            == jconfig.capture_config(jmodel).as_dict())
    assert (config.capture_config(gd).as_dict()
            == jconfig.capture_config(jgd).as_dict())
    assert model.backbone.nb_inputs == 14
    assert model.tasks[0].target_labels == ("energy",)
    x = torch.tensor([1.0, 10.0, 100.0])
    task = model.tasks[0]
    torch.testing.assert_close(task.transform_inference(task.transform_target(x)),
                               x)


def test_from_reference_config_knn_edges_and_node_level(tmp_path):
    """A KNNGraph's captured ``edge_definition`` folds into its k and
    columns; a backbone without pooling builds node-level tasks."""
    with open(_queso_like(tmp_path)) as f:
        cfg = yaml.safe_load(f)
    args = cfg["arguments"]
    args["graph_definition"]["ModelConfig"]["arguments"]["edge_definition"] = {
        "ModelConfig": {"class_name": "KNNEdges", "arguments": {
            "nb_nearest_neighbours": 16, "columns": [0, 1, 3]}}}
    for key in ("nb_nearest_neighbours", "columns"):
        del args["graph_definition"]["ModelConfig"]["arguments"][key]
    args["backbone"]["ModelConfig"]["arguments"]["global_pooling_schemes"] = None
    path = tmp_path / "node_level.yml"
    path.write_text(yaml.safe_dump(cfg))
    model, gd = tport.from_reference_config(str(path), device="cpu")
    jmodel, jgd = jport.from_reference_config(str(path))
    assert (config.capture_config(gd).as_dict()
            == jconfig.capture_config(jgd).as_dict())
    assert gd.edge_definition.nb_nearest_neighbours == 16
    assert tuple(gd.edge_definition.columns) == (0, 1, 3)
    assert model.tasks[0].node_level and jmodel.tasks[0].node_level
    assert (config.capture_config(model).as_dict()
            == jconfig.capture_config(jmodel).as_dict())


def test_unknown_lambda_raises():
    with pytest.raises(ValueError, match="Unknown reference lambda"):
        tport._resolve_lambda("!lambda x: x ** 3")
    assert tport._resolve_lambda(
        "!lambda x: torch.nn.functional.softmax(x, dim=-1)") is (
            config.TRANSFORM_REGISTRY["softmax"])


def _dataset_config(tmp_path, selection):
    cfg = {
        "path": EXAMPLE_SQLITE_DATA,
        "graph_definition": {"class_name": "KNNGraph", "arguments": {
            "detector": {"class_name": "Prometheus", "arguments": {}}}},
        "pulsemaps": ["total"],
        "features": list(FEATURES.PROMETHEUS),
        "truth": ["total_energy"],
        "truth_table": "mc_truth",
        "selection": selection,
    }
    path = str(tmp_path / "ds.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.mark.parametrize("selection", [
    ["event_no % 2 == 0", "event_no % 2 == 1"],
    {"train": "event_no % 5 > 0", "test": "event_no % 5 == 0"},
], ids=["ensemble", "named"])
def test_from_reference_dataset_config_matches_jax(selection, tmp_path):
    path = _dataset_config(tmp_path, selection)
    got, exp = tport.from_reference_dataset_config(path), (
        jport.from_reference_dataset_config(path))
    pairs = ([(got[k], exp[k]) for k in exp] if isinstance(exp, dict)
             else [(got, exp)])
    assert isinstance(got, dict) == isinstance(exp, dict)
    if not isinstance(exp, dict):
        assert isinstance(got, EnsembleDataset)
    assert sum(len(g) for g, _ in pairs) == 50
    for g, e in pairs:
        assert len(g) == len(e)
        for i in (0, len(e) - 1):
            np.testing.assert_array_equal(g[i].x, e[i].x)
            assert float(g[i].labels["total_energy"]) == float(
                e[i].labels["total_energy"])


def test_parquet_dataset_config_is_not_ported(tmp_path):
    """A Parquet dataset config builds the port's ParquetDataset (it
    raised before the dataset was ported): the JAX package's events."""
    from graphnet_tpu_torch.data.parquet_dataset import ParquetDataset

    cfg = {"path": "$GRAPHNET/data/examples/parquet/prometheus/merged",
           "graph_definition": {"class_name": "KNNGraph", "arguments": {
               "detector": {"class_name": "Prometheus", "arguments": {}}}},
           "pulsemaps": ["total"], "features": list(FEATURES.PROMETHEUS),
           "truth": ["total_energy"], "truth_table": "mc_truth",
           "selection": [3, 8]}
    path = tmp_path / "pq.yml"
    path.write_text(yaml.safe_dump(cfg))
    got = tport.from_reference_dataset_config(str(path))
    exp = jport.from_reference_dataset_config(str(path))
    assert isinstance(got, ParquetDataset) and len(got) == len(exp) > 0
    for i in range(len(exp)):
        np.testing.assert_array_equal(got[i].x, exp[i].x)
        assert float(got[i].labels["total_energy"]) == float(
            exp[i].labels["total_energy"])


# the five backbones as narrow GraphNeT configs would name them (RNN_TITO
# by GraphNeT's class name; ConvNet's width as GraphNeT's `nb_outputs`)
_REFERENCE_BACKBONES = {
    "DynEdgeJINST": ("DynEdgeJINST", dict(nb_inputs=14, layer_size_scale=1)),
    "ConvNet": ("ConvNet", dict(nb_inputs=14, nb_outputs=6,
                                nb_intermediate=8, dropout_ratio=0.3)),
    "ParticleNeT": ("ParticleNeT", dict(
        nb_inputs=14, nb_neighbours=8, dynedge_layer_sizes=[[8, 8], [16, 16]],
        readout_layer_sizes=[12], global_pooling_schemes=["mean"])),
    "ISeeCube": ("ISeeCube", dict(hidden_dim=32, seq_length=40, num_layers=1,
                                  num_heads=4, mlp_dim=48)),
    "RNNTITO": ("RNN_TITO", dict(
        nb_inputs=6, time_series_columns=[4, 3], rnn_hidden_size=12,
        dyntrans_layer_sizes=[[32, 32]], post_processing_layer_sizes=[40, 32],
        readout_layer_sizes=[32, 16], n_head=2)),
}


@pytest.mark.parametrize("backbone", ["DynEdgeJINST", "ConvNet", "ParticleNeT",
                                      "ISeeCube", "RNNTITO"])
def test_unported_backbones_name_roadmap_item_9(backbone, tmp_path):
    """The five backbones that ROADMAP.md queue 1, item 9 listed as
    unported now port: a GraphNeT config naming each builds through
    ``from_reference_config`` (the JAX package's config where it
    translates the name too), a GraphNeT-layout checkpoint of it goes
    through ``port_state_dict`` into a strict load (running statistics
    without frozen ones warn), and ``port_reference_model`` serves the
    batch-norm backbones with the checkpoint's running statistics."""
    with open(_queso_like(tmp_path)) as f:
        cfg = yaml.safe_load(f)
    name, args = _REFERENCE_BACKBONES[backbone]
    cfg["arguments"]["backbone"] = {
        "ModelConfig": {"class_name": name, "arguments": args}}
    path = tmp_path / "other.yml"
    path.write_text(yaml.safe_dump(cfg))
    model, gd = tport.from_reference_config(str(path), device="cpu")
    assert type(model.backbone).__name__ == backbone
    assert type(gd).__name__ == "KNNGraph"
    if name != "RNN_TITO":  # a name the JAX registry does not know
        jmodel, _ = jport.from_reference_config(str(path))
        assert (config.capture_config(model).as_dict()
                == jconfig.capture_config(jmodel).as_dict())
    checkpoint = graphnet_state_dict(model, np.random.default_rng(0))
    frozen = backbone in ("ConvNet", "ParticleNeT")
    if frozen:
        with pytest.warns(UserWarning, match="running statistics"):
            sd = tport.port_state_dict(model, checkpoint)
    else:
        sd = tport.port_state_dict(model, checkpoint)
    model.load_state_dict(sd)
    pkl = tmp_path / "checkpoint.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(checkpoint, f)
    ported, _, sd = tport.port_reference_model(str(path), str(pkl),
                                               device="cpu")
    assert getattr(ported.backbone, "frozen_batchnorm", False) == frozen
    if backbone == "ConvNet":
        np.testing.assert_array_equal(
            sd["backbone.bn_var"].numpy(),
            checkpoint["backbone.batchnorm1.running_var"])
    if backbone == "ParticleNeT":
        np.testing.assert_array_equal(
            sd["backbone.conv_1.bn_1.mean"].numpy(),
            checkpoint["backbone._conv_layers.1.nn.4.running_mean"])


# --------------------------------------------- stand-in checkpoints
def _narrow_deepice(**kw):
    d = dict(hidden_dim=32, head_size=16, seq_length=32, depth=1, depth_rel=2,
             n_rel=1, n_features=6, **kw)
    return JaxStandardModel(
        backbone=JaxDeepIce(**d),
        tasks=(JaxIdentityTask(nb_outputs=3, loss_function=JaxLogCosh(),
                               target_labels=("direction",)),))


_STAND_IN = {
    "jinst": (lambda: JaxJINST(nb_inputs=4, layer_size_scale=1), 4,
              jport.port_jinst_state_dict),
    "convnet": (lambda: JaxConvNet(nb_inputs=4, nb_intermediate=8,
                                   frozen_batchnorm=True), 4,
                jport.port_convnet_state_dict),
    "particlenet": (lambda: JaxParticleNeT(
        nb_inputs=4, nb_neighbours=8, dynedge_layer_sizes=((8, 8), (16, 16)),
        readout_layer_sizes=(12,), frozen_batchnorm=True), 4,
        jport.port_particlenet_state_dict),
    "iseecube": (lambda: JaxISeeCube(
        hidden_dim=32, seq_length=40, num_layers=2, num_heads=4, mlp_dim=48,
        scaled_emb=True), 6, jport.port_iseecube_state_dict),
    "rnn_tito": (lambda: JaxRNNTITO(
        nb_inputs=6, time_series_columns=(4, 3), rnn_layers=2,
        rnn_hidden_size=12, dyntrans_layer_sizes=((32, 32), (32, 32)),
        post_processing_layer_sizes=(40, 32), readout_layer_sizes=(32, 16),
        n_head=2), 6, jport.port_rnn_tito_state_dict),
}


@pytest.mark.parametrize("kind", ["dynedge", "deepice", "deepice_scaled_dynedge",
                                  *_STAND_IN])
def test_stand_in_checkpoint_has_graphnet_layout(kind):
    """``graphnet_state_dict`` (the chip run's stand-in checkpoint): the
    JAX porter reads every key of it (an unused one would raise), and the
    port's porter gives the same parameters."""
    if kind == "dynedge":
        jmodel = jw._flax_model()
        width = jw.D
    elif kind in _STAND_IN:
        backbone, width, jporter = _STAND_IN[kind]
        jmodel = JaxStandardModel(backbone=backbone(), tasks=(JaxIdentityTask(
            nb_outputs=1, loss_function=JaxLogCosh(),
            target_labels=("total_energy",)),))
    else:
        dyn = None
        if kind == "deepice_scaled_dynedge":
            dyn = dict(nb_inputs=6, nb_neighbours=4,
                       dynedge_layer_sizes=((16, 24), (24, 24)),
                       post_processing_layer_sizes=(24, 16),
                       global_pooling_schemes=None, activation_layer="gelu",
                       add_norm_layer=True, skip_readout=True)
        jmodel = _narrow_deepice(scaled_emb=dyn is not None,
                                 include_dynedge=dyn is not None,
                                 dynedge_args=dyn)
        width = 6
    model = _port_model(jmodel)
    checkpoint = graphnet_state_dict(model, np.random.default_rng(4))
    xs = np.random.default_rng(5).standard_normal((2, 16, width)).astype(
        np.float32)
    # the new kinds' porters fill every leaf: the tree's shapes will do
    init = jax.eval_shape if kind in _STAND_IN else (lambda f, *a: f(*a))
    template = init(jmodel.init, jax.random.PRNGKey(0),
                    jax_make_batch(list(xs), length=16))
    if kind not in _STAND_IN:
        jporter = (jport.port_dynedge_state_dict if kind == "dynedge"
                   else jport.port_deepice_state_dict)
    params = jporter(checkpoint, template)
    got = tport.port_state_dict(model, checkpoint)
    _assert_same_state(got, params_from_jax(jax.device_get(params),
                                            model.state_dict()))


# ---------------------------------------------------------- one call
def test_port_reference_model_and_the_example_serve_like_jax(tmp_path):
    """The example's stand-in artifacts (a GraphNeT DynEdge config and a
    pickled checkpoint): ``port_reference_model`` returns the model with
    the ported weights loaded, its graph definition and the state_dict;
    the example's ``main`` serves the bundled database's first 8 events
    as the JAX package's ``port_reference_model`` and
    ``DeploymentModule`` do (rtol 2e-4, atol 2e-5: a prediction near 0 is
    a difference of large sums)."""
    config_path, weights_path = port_pretrained.make_reference_artifacts(
        str(tmp_path), seed=3)
    model, gd, sd = tport.port_reference_model(config_path, weights_path,
                                               device="cpu")
    _assert_same_state(model.state_dict(), sd)
    assert type(gd).__name__ == "KNNGraph"
    preds = port_pretrained.main(["--device", "cpu", "--workdir",
                                  str(tmp_path), "--ref-config", config_path,
                                  "--ref-state-dict", weights_path])

    jmodel, jgd, params = jport.port_reference_model(config_path, weights_path)
    _assert_same_state(sd, params_from_jax(jax.device_get(params),
                                           model.state_dict()))
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jconfig.save_model_config(jmodel, str(jdir / "model.yml"))
    with open(jdir / "state_dict.pkl", "wb") as f:
        pickle.dump(jax.device_get(params), f)
    ds = JaxSQLiteDataset(path=EXAMPLE_SQLITE_DATA, graph_definition=jgd,
                          pulsemaps="total", features=FEATURES.PROMETHEUS,
                          truth=TRUTH.PROMETHEUS, truth_table="mc_truth")
    exp = JaxDeploymentModule(str(jdir / "model.yml"),
                              str(jdir / "state_dict.pkl"))(
        [ds[i] for i in range(8)])
    assert preds.shape == (8, 1) and np.isfinite(preds).all()
    np.testing.assert_allclose(preds, np.asarray(exp), rtol=2e-4, atol=2e-5)


def test_port_reference_model_defaults_to_the_gpu(tmp_path):
    config_path, weights_path = port_pretrained.make_reference_artifacts(
        str(tmp_path), seed=3)
    if torch.cuda.is_available():
        model, _, _ = tport.port_reference_model(config_path, weights_path)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tport.port_reference_model(config_path, weights_path)


def test_example_cli_defaults(tmp_path):
    args = port_pretrained.parse_args(["--workdir", str(tmp_path)])
    assert args.device == "cuda" and args.ref_config is None
    with pytest.raises(SystemExit):
        port_pretrained.parse_args(["--ref-config", "a.yml"])
    cfg = port_pretrained.reference_config()
    assert cfg["arguments"]["backbone"]["ModelConfig"]["class_name"] == "DynEdge"
