"""The backbones of GraphNeT's zoo beside DynEdge, TITO and DeepIce, in the
port against the JAX package on the CPU: DynEdgeJINST, ConvNet (batch
and frozen statistics), ParticleNeT (pooled and node-level), ISeeCube and
RNN_TITO (its NodeRNN on its own too) with the same random parameters
predict within rtol 2e-4; ``NodeAsDOMTimeSeries`` and
``PercentileClusters`` give the JAX arrays bit for bit on the bundled
database's events, alone and behind a ``KNNGraph``; a ``model.yml`` the
JAX package saved builds in the port and dumps the same file; each
backbone is served by ``DeploymentModule`` from the same files as the
JAX package's.  RNN_TITO's attention has heads of 16: the flash path."""

import pickle
import sqlite3

import numpy as np
import pytest
import torch

import jax

import graphnet_tpu.utils.config as jconfig
from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.deployment.deployment_module import (
    DeploymentModule as JaxDeploymentModule,
)
from graphnet_tpu.models.detector.prometheus import Prometheus as JaxPrometheus
from graphnet_tpu.models.gnn.convnet import ConvNet as JaxConvNet
from graphnet_tpu.models.gnn.dynedge_jinst import DynEdgeJINST as JaxJINST
from graphnet_tpu.models.gnn.particlenet import ParticleNeT as JaxParticleNeT
from graphnet_tpu.models.gnn.rnn_tito import RNNTITO as JaxRNNTITO
from graphnet_tpu.models.graphs.graphs import KNNGraph as JaxKNNGraph
from graphnet_tpu.models.graphs.nodes import (
    NodeAsDOMTimeSeries as JaxNodeAsDOMTimeSeries,
    PercentileClusters as JaxPercentileClusters,
)
from graphnet_tpu.models.rnn.node_rnn import NodeRNN as JaxNodeRNN
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    EnergyReconstruction as JaxEnergy,
)
from graphnet_tpu.models.transformer.iseecube import ISeeCube as JaxISeeCube
from graphnet_tpu.training.loss_functions import LogCoshLoss as JaxLogCosh
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES
from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.graphs.graphs import KNNGraph
from graphnet_tpu_torch.models.graphs.nodes import (
    NodeAsDOMTimeSeries,
    PercentileClusters,
)
from graphnet_tpu_torch.models.rnn.node_rnn import NodeRNN
from graphnet_tpu_torch.models.transformer.iseecube import ISeeCube
from graphnet_tpu_torch.utils import config
from graphnet_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(2)

PROMETHEUS = list(FEATURES.PROMETHEUS)  # sensor_pos_x, _y, _z, t
L = 32
LENGTHS = (23, 0, 1, 17, 9)
# RNN_TITO narrow: 32 wide with two heads of 16 (RNN_TITO's head dim)
RNN_TITO_NARROW = dict(
    nb_inputs=6, time_series_columns=(4, 3), rnn_layers=2, rnn_hidden_size=12,
    dyntrans_layer_sizes=((32, 32), (32, 32)),
    post_processing_layer_sizes=(40, 32), readout_layer_sizes=(32, 16),
    n_head=2)
BACKBONES = {
    "jinst": lambda: JaxJINST(nb_inputs=4, layer_size_scale=1),
    "convnet": lambda: JaxConvNet(nb_inputs=4, nb_outputs_=6,
                                  nb_intermediate=8),
    "convnet_frozen": lambda: JaxConvNet(nb_inputs=4, nb_outputs_=6,
                                         nb_intermediate=8,
                                         frozen_batchnorm=True),
    "particlenet": lambda: JaxParticleNeT(
        nb_inputs=4, nb_neighbours=8, dynedge_layer_sizes=((8, 8), (16, 16)),
        readout_layer_sizes=(12,)),
    "particlenet_frozen_node_level": lambda: JaxParticleNeT(
        nb_inputs=4, nb_neighbours=8, dynedge_layer_sizes=((8, 8, 8),),
        readout_layer_sizes=(12,), global_pooling_schemes=(),
        frozen_batchnorm=True),
    "iseecube": lambda: JaxISeeCube(
        hidden_dim=32, seq_length=40, num_layers=2, num_heads=4, mlp_dim=48,
        rel_pos_buckets=16, max_rel_pos=32),
    "rnn_tito": lambda: JaxRNNTITO(**RNN_TITO_NARROW),
}


def _jax_model(kind):
    backbone = BACKBONES[kind]()
    return JaxStandardModel(backbone=backbone, tasks=(JaxEnergy(
        loss_function=JaxLogCosh(), node_level=kind.endswith("node_level")),))


def _port_model(jmodel):
    """The port model of a JAX model's config, on the CPU."""
    return config.build(config.ModelConfig.from_dict(
        jconfig.capture_config(jmodel).as_dict()), seed=0, device="cpu")


def _dom_events(rng, lengths, charge=False):
    """Raw events of ``[x, y, z, t]`` (``charge``: and a log10 charge)
    whose pulses fall on a few sensors at random positions, through
    ``NodeAsDOMTimeSeries``: ``[x, y, z, t, charge, new_node_col]``."""
    keys = ["x", "y", "z", "t"] + (["charge"] if charge else [])
    nodes = NodeAsDOMTimeSeries(
        keys=keys, id_columns=keys[:3], time_column="t",
        charge_column="charge" if charge else "no_charge")
    events = []
    for n in lengths:
        sensors = rng.standard_normal((max(n // 3, 1), 3)) * 50
        cols = [sensors[rng.integers(0, len(sensors), n)],
                rng.random((n, 1)) * 1e3]
        if charge:
            cols.append(rng.normal(0, 0.3, (n, 1)))
        events.append(nodes(np.concatenate(cols, axis=1)))
    return events


def _events(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "rnn_tito":
        return _dom_events(rng, LENGTHS)
    if kind == "iseecube":
        events = [rng.standard_normal((n, 6)).astype(np.float32) * 2.0
                  for n in LENGTHS]
        for e in events:
            e[:, 5] = e[:, 5] > 0
        return events
    return [rng.standard_normal((n, 4)).astype(np.float32) * 2.0
            for n in LENGTHS]


def _random_params(jmodel, jbatch, seed):
    """Random parameters of the model's tree: matrices N(0, 1/fan_in),
    the rest N(0, 0.25); frozen batch-norm variances in [0.5, 1.5)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jbatch)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name in ("var", "bn_var"):
            return (0.5 + rng.random(s.shape)).astype(np.float32)
        scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.5
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("kind", list(BACKBONES))
def test_backbone_predicts_like_jax(kind):
    """Both packages' models of one config, with the same random
    parameters (``params_from_jax``), on the same events (one empty, one
    of a single pulse): predictions within rtol 2e-4."""
    events = _events(kind, 0)
    jmodel = _jax_model(kind)
    jb = jax_make_batch(events, length=L)
    params = _random_params(jmodel, jb, 1)
    model = _port_model(jmodel)
    model.load_state_dict(params_from_jax(params, model.state_dict()))
    exp = np.asarray(jmodel.apply(params, jb)[0][0])
    with torch.no_grad():
        got = model(make_batch(events, length=L))[0][0].numpy()
    assert got.shape == exp.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-5)


def test_rnn_tito_attention_takes_the_flash_path():
    """RNN_TITO's heads of 16 pass the flash gate, so on the card its
    attention runs on the flash kernels (rows 5a-c)."""
    model = _port_model(_jax_model("rnn_tito"))
    for i in range(2):
        mha = getattr(model.backbone.dynedge_tito, f"conv_{i}").transformer.mha
        assert mha.qkv.in_features // mha.num_heads == 16
        assert mha.uses_flash()


@pytest.mark.parametrize("num_layers,embedding_dim,final_state_layer",
                         [(1, 0, 0), (2, 0, 0), (2, 4, 1), (1, 4, 0)])
def test_node_rnn_matches_jax(num_layers, embedding_dim, final_state_layer):
    """NodeRNN alone: the sensor nodes (summary features, asinh of the
    charge sums, the GRU state of the chosen layer after each sensor's
    last pulse) and their mask; the packed GRU equals the JAX package's
    resetting scan."""
    rng = np.random.default_rng(2)
    events = _dom_events(rng, (30, 0, 1, 12), charge=True)
    kw = dict(nb_inputs=2, hidden_size=6, num_layers=num_layers,
              time_series_columns=(4, 3), embedding_dim=embedding_dim,
              final_state_layer=final_state_layer)
    jmod = JaxNodeRNN(**kw)
    jb = jax_make_batch(events, length=L)
    params = _random_params(jmod, jb, 3)
    exp = jmod.apply(params, jb)
    tmod = NodeRNN(**kw)
    tmod.load_state_dict(params_from_jax(params, tmod.state_dict()))
    with torch.no_grad():
        got = tmod(make_batch(events, length=L))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(exp.mask))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(exp.x), rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_array_equal(got.n_pulses.numpy(),
                                  np.asarray(exp.n_pulses))


def test_iseecube_raises_beyond_its_sequence_length():
    """Events padded beyond ``seq_length`` raise in both packages (no
    silent crop)."""
    jmodel = _jax_model("iseecube")
    model = _port_model(jmodel)
    events = [np.zeros((41, 6), np.float32)]
    with pytest.raises(AssertionError, match="seq_length"):
        jmodel.init(jax.random.PRNGKey(0), jax_make_batch(events, length=64))
    with pytest.raises(ValueError, match="seq_length"):
        model(make_batch(events, length=64))
    assert isinstance(model.backbone, ISeeCube)


# ------------------------------------------------------- node definitions
def _database_events(n_events=12):
    """The first events of the bundled database: ``[n, 4]`` float64
    pulses (sensor x, y, z, t)."""
    conn = sqlite3.connect(EXAMPLE_SQLITE_DATA)
    try:
        rows = conn.execute(
            "SELECT event_no, sensor_pos_x, sensor_pos_y, sensor_pos_z, t "
            "FROM total ORDER BY event_no").fetchall()
    finally:
        conn.close()
    rows = np.asarray(rows, np.float64)
    ids = np.unique(rows[:, 0])[:n_events]
    return [rows[rows[:, 0] == i, 1:] for i in ids]


def _with_charge(events, seed):
    rng = np.random.default_rng(seed)
    return [np.concatenate([e, rng.normal(0, 0.4, (len(e), 1))], axis=1)
            for e in events]


@pytest.mark.parametrize("charge", [False, True], ids=["no_charge", "charge"])
def test_node_as_dom_time_series_matches_jax(charge):
    events = _database_events()
    keys = PROMETHEUS + (["charge"] if charge else [])
    if charge:
        events = _with_charge(events, 4)
    kw = dict(keys=keys, id_columns=PROMETHEUS[:3], time_column="t",
              charge_column="charge" if charge else "t_not_a_charge")
    got_nodes, exp_nodes = NodeAsDOMTimeSeries(**kw), JaxNodeAsDOMTimeSeries(
        **kw)
    assert got_nodes.output_feature_names == exp_nodes.output_feature_names
    for x in events + [events[0][:0]]:
        got, exp = got_nodes(x), exp_nodes(x)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("percentiles,add_counts",
                         [([10, 50, 90], True), ([0, 25, 75, 100], False)])
def test_percentile_clusters_match_jax(percentiles, add_counts):
    events = _with_charge(_database_events(), 5)
    names = PROMETHEUS + ["charge"]
    kw = dict(cluster_on=PROMETHEUS[:3], percentiles=percentiles,
              add_counts=add_counts, input_feature_names=names)
    got_nodes, exp_nodes = PercentileClusters(**kw), JaxPercentileClusters(**kw)
    assert got_nodes.output_feature_names == exp_nodes.output_feature_names
    for x in events:
        got, exp = got_nodes(x), exp_nodes(x)
        assert got.dtype == np.float32 and len(got) <= len(x)
        np.testing.assert_array_equal(got, exp)


def _dom_graphs():
    """RNN_TITO's graph definition in both packages (JAX example 05):
    Prometheus, ``NodeAsDOMTimeSeries`` with a unit charge inserted."""
    kw = dict(keys=PROMETHEUS, id_columns=PROMETHEUS[:3], time_column="t",
              charge_column="t_not_a_charge")
    return (KNNGraph(Prometheus(), node_definition=NodeAsDOMTimeSeries(**kw)),
            JaxKNNGraph(JaxPrometheus(),
                        node_definition=JaxNodeAsDOMTimeSeries(**kw)))


def test_dom_time_series_graph_events_match_jax():
    gd, jgd = _dom_graphs()
    assert gd.output_feature_names == jgd.output_feature_names
    for x in _database_events():
        got, exp = gd(x, PROMETHEUS), jgd(x, PROMETHEUS)
        assert got.features == exp.features
        np.testing.assert_array_equal(got.x, exp.x)


# ------------------------------------------------------------ model files
@pytest.mark.parametrize("kind", list(BACKBONES))
def test_jax_saved_model_file_builds_in_the_port(kind, tmp_path):
    """``save_model_config`` of the JAX package builds in the port
    (``load_model``), which dumps the same file."""
    jmodel = _jax_model(kind)
    path, again = tmp_path / "model.yml", tmp_path / "port.yml"
    jconfig.save_model_config(jmodel, str(path))
    model = config.load_model(str(path), device="cpu")
    assert type(model.backbone).__name__ == type(jmodel.backbone).__name__
    config.save_model_config(model, str(again))
    assert again.read_text() == path.read_text()


# ---------------------------------------------------------------- serving
SERVED = {
    "jinst": lambda: JaxJINST(nb_inputs=4, layer_size_scale=1),
    "convnet": lambda: JaxConvNet(nb_inputs=4, nb_intermediate=8,
                                  frozen_batchnorm=True),
    "particlenet": lambda: JaxParticleNeT(
        nb_inputs=4, nb_neighbours=8, dynedge_layer_sizes=((8, 8), (16, 16)),
        readout_layer_sizes=(12,), frozen_batchnorm=True),
    "iseecube": lambda: JaxISeeCube(
        hidden_dim=32, seq_length=64, num_layers=1, num_heads=4, mlp_dim=48,
        n_features=4),
    "rnn_tito": lambda: JaxRNNTITO(**RNN_TITO_NARROW),
}


@pytest.mark.parametrize("kind", list(SERVED))
def test_backbone_served_like_jax(kind, tmp_path):
    """``DeploymentModule(model.yml, state_dict.pkl)`` of both packages
    on the same raw pulses of the bundled database's geometry through
    each package's graph definition (Prometheus; RNN_TITO's with
    ``NodeAsDOMTimeSeries``): the same answers (rtol 2e-4), NaN where
    the JAX package's is."""
    jmodel = JaxStandardModel(backbone=SERVED[kind](), tasks=(JaxEnergy(
        loss_function=JaxLogCosh()),))
    if kind == "rnn_tito":
        gd, jgd = _dom_graphs()
    else:
        gd, jgd = KNNGraph(Prometheus()), JaxKNNGraph(JaxPrometheus())
    pool = np.concatenate(_database_events(40))
    rng = np.random.default_rng(6)
    raws = [pool[rng.choice(len(pool), n, replace=False)]
            for n in (0, 1, 26, 60)]
    events = [gd(x, PROMETHEUS) for x in raws]
    jevents = [jgd(x, PROMETHEUS) for x in raws]
    params = _random_params(jmodel, jax_make_batch(
        [e.x for e in jevents[1:]], length=64), 7)
    path, pkl = tmp_path / "model.yml", tmp_path / "state_dict.pkl"
    jconfig.save_model_config(jmodel, str(path))
    with open(pkl, "wb") as f:
        pickle.dump(params, f)
    got = DeploymentModule(str(path), str(pkl), device="cpu")(events)
    exp = np.asarray(JaxDeploymentModule(str(path), str(pkl))(jevents))
    # an event without pulses is NaN in both for some backbones
    # (JINST's pooled pulse count)
    assert got.shape == exp.shape and np.isfinite(got[1:]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    ok = ~np.isnan(exp)
    np.testing.assert_allclose(got[ok], exp[ok], rtol=2e-4, atol=2e-5)


# ------------------------------------------------------- the chip phase
def _narrow_port_backbone(kind):
    from graphnet_tpu_torch.models.gnn.convnet import ConvNet
    from graphnet_tpu_torch.models.gnn.dynedge_jinst import DynEdgeJINST
    from graphnet_tpu_torch.models.gnn.particlenet import ParticleNeT
    from graphnet_tpu_torch.models.gnn.rnn_tito import RNNTITO

    return {
        "DynEdgeJINST": lambda: DynEdgeJINST(nb_inputs=4, layer_size_scale=1),
        "ConvNet": lambda: ConvNet(nb_inputs=4, nb_intermediate=16,
                                   frozen_batchnorm=True),
        "ParticleNeT": lambda: ParticleNeT(
            nb_inputs=4, dynedge_layer_sizes=((16, 16), (32, 32), (32, 32)),
            frozen_batchnorm=True),
        "ISeeCube": lambda: ISeeCube(hidden_dim=48, num_layers=2,
                                     num_heads=3, mlp_dim=64),
        "RNNTITO": lambda: RNNTITO(**dict(
            RNN_TITO_NARROW, dyntrans_layer_sizes=((32, 32),) * 4)),
    }[kind]()


@pytest.mark.parametrize("kind", ["DynEdgeJINST", "ConvNet", "ParticleNeT",
                                  "ISeeCube", "RNNTITO"])
def test_serve_backbones_phase_rehearsed_on_the_cpu(kind, monkeypatch):
    """``chip_smoke.serve_backbone`` on the CPU with narrow models in
    ``backbone_model``'s place (``backbone_graph`` kept), events of at
    most 120 pulses, and the plain versions counted as launches: the
    phase's launch table holds (RNN_TITO's attention through the flash
    operator at head dim 16) and the answers agree with themselves."""
    import chip_smoke
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import (
        EnergyReconstruction,
    )
    from graphnet_tpu_torch.ops import edgeconv_cuda, knn_cuda
    from graphnet_tpu_torch.ops import flash_attention_cuda as fa
    from graphnet_tpu_torch.training.loss_functions import LogCoshLoss

    counted = ((knn_cuda, "knn_graph_plain", knn_cuda.knn_graph_cuda),
               (edgeconv_cuda, "fused_edgeconv_plain",
                edgeconv_cuda.fused_edgeconv),
               (fa, "flash_attention_plain", fa.flash_attention_fwd))
    for module, name, counter in counted:
        def count(*args, _plain=getattr(module, name), _counter=counter):
            _counter.launches += 1
            return _plain(*args)
        monkeypatch.setattr(module, name, count)
        monkeypatch.setattr(counter, "launches", 0)
    def narrow(kind, device):
        backbone = _narrow_port_backbone(kind)
        return StandardModel(backbone, [EnergyReconstruction(
            hidden_size=backbone.nb_outputs, loss_function=LogCoshLoss(),
            target_labels=("total_energy",))], device=device), (
                chip_smoke.backbone_graph(kind))

    monkeypatch.setattr(chip_smoke, "backbone_model", narrow)
    monkeypatch.setattr(chip_smoke, "ZOO_RUNS", 1)
    monkeypatch.setattr(chip_smoke, "ZOO_LENGTHS",
                        (0, 1, 5, 26, 40, 60, 99, 120))
    counters = [c for _, _, c in counted]
    expect = [chip_smoke.BACKBONE_LAUNCHES[kind][i] for i in (0, 1, 3)]
    report = chip_smoke.serve_backbone(
        torch, kind, "cpu", np.random.default_rng(0),
        chip_smoke.sqlite_pulse_pool(), counters, ("knn", "edgeconv",
                                                   "flash_fwd"), expect, "")
    assert report["requests"][0]["max_rel_err"] == 0.0
    assert [report["launches"][n] for n in ("knn", "edgeconv",
                                            "flash_fwd")] == expect
