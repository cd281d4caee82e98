"""The port's GraphNeT checkpoint and config porters
(``graphnet_tpu_torch/utils/weight_port.py``) against the JAX package's
on the CPU.  The checkpoints come from the JAX tests' torch models in
GraphNeT's key layout (``tests/test_weight_port.py``: DynEdge and TITO;
``tests/test_weight_port_deepice.py``: DeepIce plain and scaled with the
nested DynEdge): each port porter gives exactly ``params_from_jax`` of
the JAX porter's tree, and the port model with it reproduces the torch
model's activations at the JAX tests' tolerances.  Missing, unused and
mis-shaped keys raise in both; the GraphNeT config translations build the
same configs and datasets; the stand-in checkpoints of
``examples/port_pretrained.py`` (the chip run's) have GraphNeT's layout;
the unported backbones say so; the example serves what the JAX
example's porter serves."""

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
from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.data.sqlite_dataset import SQLiteDataset as JaxSQLiteDataset
from graphnet_tpu.deployment.deployment_module import (
    DeploymentModule as JaxDeploymentModule,
)
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models.gnn.dynedge_kaggle_tito import (
    DynEdgeTITO as JaxDynEdgeTITO,
)
from graphnet_tpu.models.gnn.icemix import DeepIce as JaxDeepIce
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
    cfg = {"path": "$GRAPHNET/data/examples/parquet/prometheus/merged",
           "pulsemaps": ["total"], "features": ["t"], "truth": ["energy"]}
    path = tmp_path / "pq.yml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(NotImplementedError, match="item 11"):
        tport.from_reference_dataset_config(str(path))


@pytest.mark.parametrize("backbone", ["DynEdgeJINST", "ConvNet", "ParticleNeT",
                                      "ISeeCube", "RNNTITO"])
def test_unported_backbones_name_roadmap_item_9(backbone, tmp_path):
    with open(_queso_like(tmp_path)) as f:
        cfg = yaml.safe_load(f)
    cfg["arguments"]["backbone"]["ModelConfig"]["class_name"] = backbone
    path = tmp_path / "other.yml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(NotImplementedError, match="item 9"):
        tport.from_reference_config(str(path), device="cpu")
    fake = type(backbone, (torch.nn.Module,), {})()
    holder = torch.nn.Module()
    holder.backbone = fake
    with pytest.raises(NotImplementedError, match=f"{backbone}.*item 9"):
        tport.port_state_dict(holder, {})


# --------------------------------------------- stand-in checkpoints
def _narrow_deepice(**kw):
    d = dict(hidden_dim=32, head_size=16, seq_length=32, depth=1, depth_rel=2,
             n_rel=1, n_features=6, **kw)
    return JaxStandardModel(
        backbone=JaxDeepIce(**d),
        tasks=(JaxIdentityTask(nb_outputs=3, loss_function=JaxLogCosh(),
                               target_labels=("direction",)),))


@pytest.mark.parametrize("kind", ["dynedge", "deepice", "deepice_scaled_dynedge"])
def test_stand_in_checkpoint_has_graphnet_layout(kind):
    """``graphnet_state_dict`` (the chip run's stand-in checkpoint): the
    JAX porter reads every key of it (an unused one would raise), and the
    port's porter gives the same parameters."""
    if kind == "dynedge":
        jmodel = jw._flax_model()
        width = jw.D
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
    template = jmodel.init(jax.random.PRNGKey(0),
                           jax_make_batch(list(xs), length=16))
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
