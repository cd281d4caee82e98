"""The pretrained zoo's files in the port against the JAX package on the
CPU: every model file of ``configs/models`` builds in the port and dumps
the JAX package's config; the IceCube and LiquidO detectors'
standardisation, the ice-transparency table and its interpolators and
``IceMixNodes`` equal the JAX package's bit for bit; each zoo graph
definition turns the same raw pulses into the same events; the
``+DynEdge`` zoo files (cut in depth) predict as the JAX models; and
each zoo directory, from a GraphNeT-layout checkpoint through the
port's porter to ``DeploymentModule``, answers as the JAX package."""

import copy
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax

import chip_smoke
import graphnet_tpu.models.detector as jdet
import graphnet_tpu.utils.config as jconfig
import graphnet_tpu.utils.weight_port as jport
from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.deployment.deployment_module import (
    DeploymentModule as JaxDeploymentModule,
)
from graphnet_tpu.models.graphs.nodes import IceMixNodes as JaxIceMixNodes
from graphnet_tpu.models.graphs.utils import (
    ice_transparency as jax_ice_transparency,
)
import graphnet_tpu_torch.models.detector as tdet
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
from graphnet_tpu_torch.examples.port_pretrained import graphnet_state_dict
from graphnet_tpu_torch.models.graphs.nodes import IceMixNodes
from graphnet_tpu_torch.models.graphs.utils import (
    ice_transparency,
    ice_transparency_table,
)
from graphnet_tpu_torch.utils import config
from graphnet_tpu_torch.utils.jax_params import params_from_jax
from graphnet_tpu_torch.utils.weight_port import port_state_dict
from tests.test_torch_config import _subset

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
MODELS = ROOT / "configs" / "models"
MODEL_FILES = sorted(str(p.relative_to(MODELS)) for p in MODELS.rglob("*.yml"))
ZOO = sorted(chip_smoke.ZOO_LAUNCHES)
GRAPH_FILES = [f"zoo/{d}/graph_definition.yml" for d in ZOO] + [
    "knn_graph_icecube86.yml"]
KAGGLE = ["x", "y", "z", "time", "charge", "auxiliary"]


def _load(name):
    with open(MODELS / name) as f:
        return yaml.safe_load(f)


def test_every_model_file_is_held():
    assert len(MODEL_FILES) == 29 and len(ZOO) == 11
    assert sum(name.endswith("graph_definition.yml")
               for name in MODEL_FILES) == 11


@pytest.mark.parametrize("name", MODEL_FILES)
def test_model_file_builds_and_dumps_like_jax(name, tmp_path):
    """Each file builds in the port at its full width (models on the CPU)
    and dumps the dict the JAX package dumps for its own build, word for
    word, with every argument the file gives."""
    path = str(MODELS / name)
    built = config.load_model(path, device="cpu")
    port_yml, jax_yml = tmp_path / "port.yml", tmp_path / "jax.yml"
    config.save_model_config(built, str(port_yml))
    jconfig.save_model_config(jconfig.load_model(path), str(jax_yml))
    assert port_yml.read_text() == jax_yml.read_text()
    assert _subset(_load(name), yaml.safe_load(port_yml.read_text()))


# ------------------------------------------------------------ detectors
@pytest.mark.parametrize("name", jdet.available_detectors())
def test_detector_standardisation_matches_jax(name):
    """Every detector: the same columns, geometry metadata and table
    path, and each column standardised to the same bits on seeded
    values."""
    assert tdet.available_detectors() == jdet.available_detectors()
    det, jd = tdet.get_detector(name), jdet.get_detector(name)
    names = list(jd.feature_map())
    assert list(det.feature_map()) == names
    assert (det.xyz, det.string_id_column, det.sensor_id_column,
            det.geometry_table_path) == (jd.xyz, jd.string_id_column,
                                         jd.sensor_id_column,
                                         jd.geometry_table_path)
    rng = np.random.default_rng(len(name))
    x = rng.uniform(0.01, 3000.0, (37, len(names)))
    np.testing.assert_array_equal(det(x, names), jd(x, names))
    with pytest.raises(KeyError, match="no_such_column"):
        det(x[:, :1], ["no_such_column"])


# ------------------------------------------------------- ice properties
def test_ice_table_text_copy_is_the_parquet():
    import pandas as pd

    df = pd.read_parquet(ROOT / "data" / "ice_properties" /
                         "ice_transparency.parquet")
    assert list(df.columns) == ["depth", "scattering_len", "absorption_len"]
    table = ice_transparency_table()
    assert table.shape == (110, 3) and table.dtype == np.float64
    np.testing.assert_array_equal(table, df.to_numpy())


@pytest.mark.parametrize("args", [{}, {"z_offset": -1900.0, "z_scaling": 400.0}],
                         ids=["defaults", "offset_scaling"])
def test_ice_transparency_matches_jax(args):
    scatt, absorb = ice_transparency(**args)
    j_scatt, j_absorb = jax_ice_transparency(**args)
    np.testing.assert_array_equal(scatt.x, j_scatt.x)
    z = np.random.default_rng(3).uniform(scatt.x.min(), scatt.x.max(), 500)
    np.testing.assert_array_equal(scatt(z), j_scatt(z))
    np.testing.assert_array_equal(absorb(z), j_absorb(z))


# --------------------------------------------------------- IceMixNodes
@pytest.mark.parametrize(
    "hlc_name,add_ice,lengths",
    [("auxiliary", True, (40, 17, 63)), ("auxiliary", True, (300, 64, 500)),
     (None, True, (40, 17, 63)), (None, True, (300, 64, 500)),
     ("auxiliary", False, (300, 1, 0))],
    ids=["hlc_below", "hlc_above", "no_hlc_below", "no_hlc_above",
         "no_ice_above"])
def test_icemix_nodes_match_jax(hlc_name, add_ice, lengths):
    """The same seed gives the same nodes, bit for bit, over a sequence of
    events (the generator lives as long as the object): below and above
    ``max_pulses`` = 64, with the HLC flag (HLC pulses first) and
    without it, and without the ice columns."""
    kw = dict(input_feature_names=KAGGLE, max_pulses=64, z_name="z",
              hlc_name=hlc_name, add_ice_properties=add_ice, seed=11)
    nodes, jnodes = IceMixNodes(**kw), JaxIceMixNodes(**kw)
    assert nodes.output_feature_names == jnodes.output_feature_names
    rng = np.random.default_rng(5)
    for n in lengths:
        x = rng.standard_normal((n, 6))
        x[:, 2] = rng.uniform(-1.0, 1.0, n)  # within the ice table's depths
        x[:, 5] = rng.random(n) > 0.7
        got, exp = nodes(x), jnodes(x)
        assert got.dtype == np.float32 and got.shape == (min(n, 64), len(
            nodes.output_feature_names))
        np.testing.assert_array_equal(got, exp)


# -------------------------------------------------- graph definitions
def _graph_definitions(name):
    """Both packages' graph definitions of a file, an IceMix node
    definition seeded (the files leave the seed null, so each package
    would draw its own subsample)."""
    d = _load(name)
    node = d["arguments"].get("node_definition")
    if node and node["__model__"]["class_name"] == "IceMixNodes":
        node["__model__"]["arguments"]["seed"] = 17
    return (config.build(config.ModelConfig.from_dict(copy.deepcopy(d))),
            jconfig.build(jconfig.ModelConfig.from_dict(copy.deepcopy(d))))


@pytest.fixture(scope="module")
def pulse_pool():
    return chip_smoke.sqlite_pulse_pool()


@pytest.mark.parametrize("name", GRAPH_FILES)
def test_graph_definition_events_match_jax(name, pulse_pool):
    """Raw pulses drawn from the bundled database's geometry, the other
    columns by name (``chip_smoke.zoo_raw_pulses``, as the chip run
    builds them; IceMix events longer than its 192 pulses subsampled),
    turn into the same events in both packages, bit for bit."""
    gd, jgd = _graph_definitions(name)
    names = list(gd._input_feature_names)
    assert names == list(jgd._input_feature_names)
    raws = chip_smoke.zoo_raw_pulses(np.random.default_rng(8), names,
                                     pulse_pool, chip_smoke.ZOO_LENGTHS)
    for raw in raws:
        got, exp = gd(raw, names), jgd(raw, names)
        assert got.features == exp.features
        assert got.x.dtype == exp.x.dtype == np.float32
        np.testing.assert_array_equal(got.x, exp.x)
        assert got.labels == exp.labels and got.node_labels == exp.node_labels


# ------------------------------------------ the zoo served from a checkpoint
def _cut(d):
    """A zoo model file's config with its DeepIce cut to one block and
    one rel block (the widths are the file's)."""
    d = copy.deepcopy(d)
    bb = d["arguments"]["backbone"]["__model__"]
    if bb["class_name"] == "DeepIce":
        bb["arguments"].update(depth=1, depth_rel=1)
    return d


@pytest.mark.parametrize("directory", ZOO)
def test_zoo_checkpoint_served_like_jax(directory, tmp_path, pulse_pool):
    """The slice: the directory's graph definition turns raw pulses into
    events; a GraphNeT-layout checkpoint (``graphnet_state_dict`` of the
    port model, the stand-in the chip run ports) goes through the port's
    porter and the JAX package's; the port's ``DeploymentModule`` from the
    model's file and the ported ``state_dict`` answers as the JAX
    package's ``DeploymentModule`` from the same file and its ported
    parameters (rtol 2e-4).  IceMix models are cut to one block and one
    rel block at the file's widths."""
    d = _cut(_load(f"zoo/{directory}/model.yml"))
    cut = tmp_path / "model.yml"
    cut.write_text(yaml.safe_dump(d, sort_keys=False))
    gd, jgd = _graph_definitions(f"zoo/{directory}/graph_definition.yml")
    names = list(gd._input_feature_names)
    raws = chip_smoke.zoo_raw_pulses(np.random.default_rng(9), names,
                                     pulse_pool, (0, 1, 26, 99, 250))
    events = [gd(raw, names) for raw in raws]
    jevents = [jgd(raw, names) for raw in raws]

    model = config.load_model(str(cut), device="cpu")
    checkpoint = graphnet_state_dict(model, np.random.default_rng(10))
    for task in range(model.n_tasks):  # heads in range of pow10 / sigmoid
        checkpoint[f"_tasks.{task}._affine.weight"] *= 1e-3
    sd = port_state_dict(model, checkpoint)

    jmodel = jconfig.load_model(str(cut))
    template = jmodel.init(jax.random.PRNGKey(0), jax_make_batch(
        [e.x for e in jevents[1:3]], length=32))
    porter = {"DynEdge": jport.port_dynedge_state_dict,
              "DeepIce": jport.port_deepice_state_dict}[
                  type(model.backbone).__name__]
    params = jax.device_get(porter(checkpoint, template))
    exp = params_from_jax(params, model.state_dict())
    assert all(torch.equal(sd[k], exp[k]) for k in exp) and len(sd) == len(exp)
    pkl = tmp_path / "params.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(params, f)

    got = DeploymentModule(str(cut), sd, device="cpu")(events)
    ref = JaxDeploymentModule(str(cut), str(pkl))(jevents)
    node_level = isinstance(got, list)
    pairs = zip(got, ref) if node_level else [(got, ref)]
    for g, r in pairs:
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        ok = ~np.isnan(r)
        if ok.any():
            np.testing.assert_allclose(g[ok], r[ok], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", ["S+DynEdge_d32", "B+DynEdge_d64"])
def test_dynedge_zoo_file_matches_jax(name):
    """The ``+DynEdge`` files cut to one block and one rel block, built
    by both registries, with the same random parameters: predictions
    within rtol 2e-4 on events of IceMix's eight columns."""
    d = _cut(_load(f"zoo/kaggle_icemix/{name}/model.yml"))
    rng = np.random.default_rng(13)
    events = [np.concatenate(
        [rng.standard_normal((n, 3)) * 0.5, rng.random((n, 1)) * 0.03,
         rng.random((n, 1)), rng.random((n, 1)) > 0.5,
         rng.standard_normal((n, 2))], axis=1).astype(np.float32)
        for n in (40, 3, 17)]
    jb, tb = jax_make_batch(events, length=64), make_batch(events, length=64)
    jmodel = jconfig.build(jconfig.ModelConfig.from_dict(copy.deepcopy(d)))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jb)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * (
            1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.5)).astype(
                np.float32), shapes)
    model = config.build(config.ModelConfig.from_dict(d), device="cpu")
    model.load_state_dict(params_from_jax(params, model.state_dict()))
    with torch.no_grad():
        pred = model(tb)[0][0].numpy()
    np.testing.assert_allclose(pred, np.asarray(jmodel.apply(params, jb)[0][0]),
                               rtol=2e-4, atol=2e-5)
