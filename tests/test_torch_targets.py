"""The port's other GraphNeT targets against the JAX package on the CPU:
the nine reconstruction heads, the general-m vMF normaliser and Bessel
ratio, ``EuclideanDistanceLoss``, ``EnsembleLoss`` and
``RMSEVonMisesFisher3DLoss`` (rtol 2e-4), a StandardModel with the nine
heads (predictions, loss and gradients; its dumped config equal to the
JAX dump), the fitted sample weights (tables bit-equal on a copy of the
bundled database) and a weighted loss read through the dataset."""

import os
import shutil
import sqlite3

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import graphnet_tpu.models.task.reconstruction as jrec
import graphnet_tpu.training.loss_functions as jlf
import graphnet_tpu.utils.config as jconfig
from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.training import weight_fitting as jwf
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task import reconstruction as trec
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.training import weight_fitting as twf
from graphnet_tpu_torch.utils import config
from graphnet_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(2)

RTOL = 2e-4
NARROW = dict(
    dynedge_layer_sizes=((16, 32), (24, 32)),
    post_processing_layer_sizes=(24, 16),
    readout_layer_sizes=(8,),
)
NEW_HEADS = [
    "AzimuthReconstructionWithKappa", "AzimuthReconstruction",
    "EnergyReconstructionWithPower", "EnergyTCReconstruction",
    "EnergyReconstructionWithUncertainty", "VertexReconstruction",
    "PositionReconstruction", "TimeReconstruction",
    "InelasticityReconstruction",
]


def _random_tree(shapes, seed):
    """Dense kernels N(0, 1/fan_in), every other leaf N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.5
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _close(got, exp, rtol=RTOL, msg=""):
    exp = np.asarray(exp)
    np.testing.assert_allclose(np.asarray(got), exp, rtol=rtol,
                               atol=rtol * max(np.abs(exp).max(), 1e-6),
                               err_msg=msg)


# ---------------------------------------------------------- the heads
@pytest.mark.parametrize("name", NEW_HEADS)
def test_new_head_matches_jax(name):
    """Predictions, the regularisation (AzimuthReconstruction's KL
    term), and the gradients of a weighted sum of both with respect to
    the latents and the affine map; the captured config and the labels
    are the JAX module's."""
    rng = np.random.default_rng(NEW_HEADS.index(name))
    lat = rng.standard_normal((5, 8)).astype(np.float32)
    jt = getattr(jrec, name)()
    params = _random_tree(jax.eval_shape(jt.init, jax.random.PRNGKey(0),
                                         jnp.asarray(lat)), 2)
    pred_j, reg_j = jt.apply(params, jnp.asarray(lat))
    g = rng.standard_normal(np.shape(pred_j)).astype(np.float32)

    def jloss(p, x):
        pred, reg = jt.apply(p, x)
        return jnp.sum(pred * g) + 3.0 * reg

    gp_j, gx_j = jax.grad(jloss, (0, 1))(params, jnp.asarray(lat))
    tt = getattr(trec, name)(hidden_size=8)
    tt.load_state_dict(params_from_jax(params, tt.state_dict()))
    x = torch.tensor(lat, requires_grad=True)
    pred_t, reg_t = tt(x)
    ((pred_t * torch.from_numpy(g)).sum() + 3.0 * reg_t).backward()
    _close(pred_t.detach(), pred_j, msg="prediction")
    _close(reg_t.detach(), reg_j, msg="regularisation")
    _close(x.grad, gx_j, msg="latent gradient")
    gw = params_from_jax(jax.tree_util.tree_map(np.asarray, gp_j))
    for key, p in tt.named_parameters():
        _close(p.grad, gw[key], msg=key)
    assert tt.predictions == jt.predictions and tt.targets == jt.targets
    assert config.capture_config(tt).as_dict() == jconfig.capture_config(
        jt).as_dict()


# ------------------------------------------------- the vMF normaliser
KAPPAS = np.array([1e-3, 0.05, 0.5, 2.0, 10.0, 50.0, 99.0, 100.0, 101.0,
                   250.0], np.float32)


@pytest.mark.parametrize("m", [2, 3, 5, 16])
def test_log_cmk_matches_jax_and_the_series(m):
    """``log_cmk`` (value and gradient) against the JAX package's for m
    = 2, 3, 5 and 16, and the exact branch below the switch against the
    series formula ``(m/2-1) log k - log I_{m/2-1}(k) - (m/2) log 2 pi``
    of ``log_iv_series``, which m = 2 and 3 do not use.

    The series' gradient is the difference of two terms near ``nu / k``
    (``nu = m/2 - 1``), so at small ``k`` float32 leaves either package
    an absolute error of ~1e-7 of ``nu / k``: the gradient is held at
    rtol 2e-4 plus 1e-5 of ``nu / k``."""
    k = torch.from_numpy(KAPPAS).requires_grad_()
    got = tlf.log_cmk(m, k)
    got.sum().backward()
    exp, exp_g = jax.value_and_grad(lambda v: jnp.sum(jlf.log_cmk(m, v)))(
        jnp.asarray(KAPPAS))
    _close(got.detach(), jlf.log_cmk(m, jnp.asarray(KAPPAS)), msg="log_cmk")
    nu = m / 2.0 - 1.0
    err = np.abs(k.grad.numpy() - np.asarray(exp_g))
    bound = RTOL * np.abs(np.asarray(exp_g)) + 1e-5 * nu / KAPPAS
    assert (err <= bound).all(), f"gradient errors {err} above {bound}"
    below = KAPPAS < 100.0
    kb = torch.from_numpy(KAPPAS[below])
    series = (nu * torch.log(kb) - tlf.log_iv_series(nu, kb)
              - (m / 2.0) * np.log(2 * np.pi))
    _close(tlf.log_cmk_exact(m, kb), series, msg="exact vs series")
    _close(tlf.log_iv_series(nu, kb),
           jlf.log_iv_series(nu, jnp.asarray(KAPPAS[below])), msg="series")


@pytest.mark.parametrize("m", [2, 3, 5, 16])
def test_bessel_ratio_matches_jax(m):
    """``I_{m/2} / I_{m/2-1}`` against the JAX package's, and against the
    derivative of ``-log C_m`` on the exact branch."""
    kb = KAPPAS[KAPPAS < 100.0]
    _close(tlf.bessel_ratio(m, torch.from_numpy(kb)),
           jlf.bessel_ratio(m, jnp.asarray(kb)), msg="ratio")
    k = torch.from_numpy(kb[kb > 0.01]).requires_grad_()
    (-tlf.log_cmk_exact(m, k)).sum().backward()
    # d/dk (-log C_m) = I_{m/2}(k) / I_{m/2-1}(k)
    _close(k.grad, tlf.bessel_ratio(m, k.detach()), rtol=2e-3, msg="derivative")


# ---------------------------------------------------------- the losses
def _loss_pair(name):
    if name == "EnsembleLoss":
        kw = dict(loss_functions=["MSELoss", "EuclideanDistanceLoss"],
                  loss_factors=[0.5, 2.0], prediction_keys=[[3], [0, 1, 2]])
        return (jlf.EnsembleLoss(
                    [jlf.MSELoss(), jlf.EuclideanDistanceLoss()],
                    kw["loss_factors"], kw["prediction_keys"]),
                tlf.EnsembleLoss(
                    [tlf.MSELoss(), tlf.EuclideanDistanceLoss()],
                    kw["loss_factors"], kw["prediction_keys"]))
    return getattr(jlf, name)(), getattr(tlf, name)()


@pytest.mark.parametrize("name", ["EuclideanDistanceLoss", "EnsembleLoss",
                                  "RMSEVonMisesFisher3DLoss"])
def test_new_loss_matches_jax(name):
    """Value, elements (weighted) and the gradient with respect to the
    prediction ``[N, 4]``; the captured config is the JAX one."""
    rng = np.random.default_rng(6)
    pred = rng.standard_normal((7, 4)).astype(np.float32)
    if name == "RMSEVonMisesFisher3DLoss":
        pred[:, :3] /= np.linalg.norm(pred[:, :3], axis=1, keepdims=True)
        pred[:, 3] = rng.uniform(0.5, 150.0, 7)
        target = rng.standard_normal((7, 3))
        target = (target / np.linalg.norm(target, axis=1, keepdims=True))
    else:
        target = rng.standard_normal((7, 3))
    target = target.astype(np.float32)
    w = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    jl, tl = _loss_pair(name)
    val_j, grad_j = jax.value_and_grad(
        lambda p: jl(p, jnp.asarray(target), jnp.asarray(w)))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    val_t = tl(p, torch.from_numpy(target), torch.from_numpy(w))
    val_t.backward()
    _close(val_t.detach(), val_j, msg="value")
    _close(p.grad, grad_j, msg="gradient")
    _close(tl(torch.from_numpy(pred), torch.from_numpy(target),
              return_elements=True),
           jl(jnp.asarray(pred), jnp.asarray(target), return_elements=True),
           msg="elements")
    assert config.capture_config(tl).as_dict() == jconfig.capture_config(
        jl).as_dict()


# ------------------------------------- a model with the nine new heads
def _nine_heads(rec, lf, log10):
    """The nine heads with a loss each, on labels that exist (``vertex``
    and ``position`` as vectors, the rest columns)."""
    return [
        rec.AzimuthReconstructionWithKappa(
            loss_function=lf.VonMisesFisher2DLoss(),
            target_labels=("azimuth",)),
        rec.AzimuthReconstruction(loss_function=lf.MSELoss(),
                                  target_labels=("azimuth",)),
        rec.EnergyReconstructionWithPower(
            loss_function=lf.LogCoshLoss(), target_labels=("total_energy",),
            transform_prediction_and_target=log10),
        rec.EnergyTCReconstruction(
            loss_function=lf.LogCoshLoss(),
            target_labels=("energy_track", "energy_cascade"),
            transform_prediction_and_target=log10),
        rec.EnergyReconstructionWithUncertainty(
            loss_function=lf.LogCoshLoss(), target_labels=("total_energy",)),
        rec.VertexReconstruction(loss_function=lf.EuclideanDistanceLoss(),
                                 target_labels=("vertex",)),
        rec.PositionReconstruction(loss_function=lf.EuclideanDistanceLoss(),
                                   target_labels=("position",)),
        rec.TimeReconstruction(loss_function=lf.MSELoss(),
                               target_labels=("interaction_time",)),
        rec.InelasticityReconstruction(loss_function=lf.MSELoss(),
                                       target_labels=("inelasticity",)),
    ]


def _labels(rng, B):
    return {
        "azimuth": rng.uniform(0, 2 * np.pi, B).astype(np.float32),
        "total_energy": rng.uniform(10, 1000, B).astype(np.float32),
        "energy_track": rng.uniform(1, 500, B).astype(np.float32),
        "energy_cascade": rng.uniform(1, 500, B).astype(np.float32),
        "vertex": (rng.standard_normal((B, 4)) * [100, 100, 100, 1]).astype(
            np.float32),
        "position": (rng.standard_normal((B, 3)) * 100).astype(np.float32),
        "interaction_time": rng.standard_normal(B).astype(np.float32),
        "inelasticity": rng.uniform(0, 1, B).astype(np.float32),
    }


def test_nine_head_model_matches_jax(tmp_path):
    """A StandardModel with the nine heads: predictions, the summed loss
    and every parameter's gradient (rtol 2e-4), and the dumped config
    equal to the JAX model's dump, which the port loads back."""
    rng = np.random.default_rng(30)
    events = [rng.standard_normal((int(n), 4)).astype(np.float32)
              for n in rng.integers(6, 16, 6)]
    labels = _labels(rng, 6)
    jb = jax_make_batch(events, labels=labels, length=16)
    tb = make_batch(events, labels=labels, length=16)
    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4, **NARROW),
        tasks=tuple(_nine_heads(jrec, jlf, jconfig.TRANSFORM_REGISTRY["log10"])))
    yml = str(tmp_path / "jax.yml")
    jconfig.save_model_config(jmodel, yml)
    model = config.load_model(yml, device="cpu")
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3), jb))
    model.load_state_dict(params_from_jax(params, model.state_dict()))
    port_yml = str(tmp_path / "port.yml")
    config.save_model_config(model, port_yml)
    assert open(port_yml).read() == open(yml).read()

    def jloss(p):
        return jmodel.loss_from_batch(jmodel.apply(p, jb), jb)

    val_j, grad_j = jax.value_and_grad(jloss)(params)
    preds_j = [np.asarray(p) for p, _ in jmodel.apply(params, jb, inference=True)]
    out = model(tb)
    loss = model.loss_from_batch(out, tb)
    loss.backward()
    _close(loss.detach(), val_j, msg="loss")
    with torch.no_grad():
        for i, ((p, _), e) in enumerate(zip(model(tb, inference=True), preds_j)):
            _close(p, e, msg=f"task {i}")
    exp = params_from_jax(jax.device_get(grad_j), model.state_dict())
    for name, p in model.named_parameters():
        _close(p.grad, exp[name], msg=name)
    assert model.prediction_labels == jmodel.prediction_labels


# ------------------------------------------------------ sample weights
@pytest.fixture()
def two_copies(tmp_path):
    a, b = str(tmp_path / "jax.db"), str(tmp_path / "port.db")
    shutil.copy(EXAMPLE_SQLITE_DATA, a)
    shutil.copy(EXAMPLE_SQLITE_DATA, b)
    return a, b


def _rows(db, table):
    with sqlite3.connect(db) as con:
        return con.execute(f"select * from {table} order by event_no").fetchall()


FITS = [
    ("Uniform", {}),
    ("BjoernLow", dict(x_low=1.5, alpha=0.05)),
    ("BjoernLow", dict(x_low=0.4, percentile=True, max_weight=0.05,
                       db_count_norm=100)),
    ("Uniform", dict(automatic_log_bins=True, transform=None)),
]


@pytest.mark.parametrize("name,kw", FITS,
                         ids=["uniform", "bjoern_low", "bjoern_low_percentile",
                              "uniform_log_bins"])
def test_weight_fitters_write_the_jax_tables(name, kw, two_copies):
    """The same weights, bit for bit, returned (the JAX frame's columns)
    and written to the database copy (the table's rows)."""
    a, b = two_copies
    kw = dict(kw)
    fit = dict(bins=30 if kw.get("automatic_log_bins") else np.arange(0, 5, 0.1),
               variable="injection_energy",
               transform=kw.pop("transform", np.log10), add_to_database=True)
    jw = getattr(jwf, name)(a, truth_table="mc_truth").fit(**fit, **kw)
    tw = getattr(twf, name)(b, truth_table="mc_truth").fit(**fit, **kw)
    assert list(tw) == list(jw.columns)
    for c in jw.columns:
        np.testing.assert_array_equal(tw[c], jw[c].to_numpy(), err_msg=c)
    table = list(jw.columns)[-1]
    assert _rows(b, table) == _rows(a, table)


def test_weight_examples_write_the_jax_tables(tmp_path):
    """The port's two weight examples against the JAX examples' fits on
    their own copies: the same tables."""
    from graphnet_tpu_torch.examples import (
        fit_bjoern_low_weights,
        fit_uniform_weights,
    )

    for module, cls, kw, table in (
        (fit_uniform_weights, jwf.Uniform, {}, "injection_energy_uniform_weight"),
        (fit_bjoern_low_weights, jwf.BjoernLow,
         dict(x_low=1.5, alpha=0.05, weight_name="bjoern_low_weight"),
         "bjoern_low_weight"),
    ):
        ours = str(tmp_path / f"{table}_port.db")
        module.main(["--output", ours])
        ref = str(tmp_path / f"{table}_jax.db")
        shutil.copy(EXAMPLE_SQLITE_DATA, ref)
        cls(ref, truth_table="mc_truth").fit(
            bins=np.arange(0, 5, 0.1), variable="injection_energy",
            transform=np.log10, add_to_database=True, **kw)
        assert _rows(ours, table) == _rows(ref, table)
        assert os.path.getsize(EXAMPLE_SQLITE_DATA) > 0


def test_fitted_weights_weight_the_loss_as_in_jax(two_copies):
    """Uniform weights fitted into a copy, read by the datasets'
    ``loss_weight_table`` / ``loss_weight_column`` and used as a task's
    ``loss_weight``: the same batch weights and the same loss."""
    from graphnet_tpu.data.constants import FEATURES as JF, TRUTH as JT
    from graphnet_tpu.data.dataloader import DataLoader as JaxDataLoader
    from graphnet_tpu.data.sqlite_dataset import SQLiteDataset as JaxSQLiteDataset
    from graphnet_tpu.models.detector.prometheus import Prometheus as JaxPrometheus
    from graphnet_tpu.models.graphs import KNNGraph as JaxKNNGraph
    from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
    from graphnet_tpu_torch.data.dataloader import DataLoader
    from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
    from graphnet_tpu_torch.models.detector.prometheus import Prometheus
    from graphnet_tpu_torch.models.graphs import KNNGraph

    a, b = two_copies
    fit = dict(bins=np.arange(0, 5, 0.1), variable="injection_energy",
               transform=np.log10, add_to_database=True)
    jwf.Uniform(a, truth_table="mc_truth").fit(**fit)
    twf.Uniform(b, truth_table="mc_truth").fit(**fit)
    col = "injection_energy_uniform_weight"
    common = dict(pulsemaps="total", truth_table="mc_truth",
                  loss_weight_table=col, loss_weight_column=col)
    jds = JaxSQLiteDataset(path=a, graph_definition=JaxKNNGraph(
        detector=JaxPrometheus()), features=JF.PROMETHEUS, truth=JT.PROMETHEUS,
        **common)
    tds = SQLiteDataset(path=b, graph_definition=KNNGraph(detector=Prometheus()),
                        features=FEATURES.PROMETHEUS, truth=TRUTH.PROMETHEUS,
                        **common)
    jb = next(iter(JaxDataLoader(jds, batch_size=8))).unpacked()
    tb = next(iter(DataLoader(tds, batch_size=8)))
    np.testing.assert_array_equal(tb.labels[col].numpy(),
                                  np.asarray(jb.labels[col]))
    jt = jrec.EnergyReconstruction(loss_function=jlf.LogCoshLoss(),
                                   target_labels=("total_energy",),
                                   transform_prediction_and_target=
                                   jconfig.TRANSFORM_REGISTRY["log10"],
                                   loss_weight=col)
    tt = trec.EnergyReconstruction(hidden_size=1, loss_function=tlf.LogCoshLoss(),
                                   target_labels=("total_energy",),
                                   transform_prediction_and_target=
                                   config.TRANSFORM_REGISTRY["log10"],
                                   loss_weight=col)
    pred = np.linspace(20, 900, 8).astype(np.float32)[:, None]
    exp = jt.compute_loss(jnp.asarray(pred), 0.0, jb.labels)
    got = tt.compute_loss(torch.from_numpy(pred), torch.zeros(()), tb.labels)
    _close(got, exp)


# ------------------------------------------------------- the four CLIs
@pytest.mark.parametrize("name", ["fit_uniform_weights", "fit_bjoern_low_weights",
                                  "train_normalizing_flow",
                                  "train_multiclass_from_configs"])
def test_target_example_cli_runs_on_the_cpu(name, tmp_path, capsys):
    """Each of the four examples' command lines, one epoch on the CPU:
    the weight examples write into their copy and leave the bundled
    database as it was; the flow example prints its density mode; the
    classifier its validation predictions."""
    import importlib

    module = importlib.import_module(f"graphnet_tpu_torch.examples.{name}")
    with sqlite3.connect(EXAMPLE_SQLITE_DATA) as con:
        tables = con.execute("select name from sqlite_master").fetchall()
    if name.startswith("fit_"):
        out = module.main(["--output", str(tmp_path / "copy.db")])
        assert np.isfinite(list(out.values())[-1]).all()
    else:
        module.main(["--device", "cpu", "--max-epochs", "1", "--batch-size", "8"])
    text = capsys.readouterr().out
    assert {"fit_uniform_weights": "injection_energy_uniform_weight",
            "fit_bjoern_low_weights": "bjoern_low_weight",
            "train_normalizing_flow": "density mode",
            "train_multiclass_from_configs": "rows x"}[name] in text
    with sqlite3.connect(EXAMPLE_SQLITE_DATA) as con:
        assert con.execute("select name from sqlite_master").fetchall() == tables
