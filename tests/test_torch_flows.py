"""The port's density models against the JAX package's on the CPU:
``NormalizingFlow`` (both transforms) and ``SphericalFlow`` on a narrow
DynEdge, their parameters carried over by ``params_from_jax``: the
NLLH, ``log_prob``, the spline's round trip and log-determinant, the
draws' transform, ``mean_direction``, ``Trainer.fit`` and ``predict``,
and the flow example against the JAX example's path."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models import normalizing_flow as jnf
from graphnet_tpu.training.trainer import Trainer as JaxTrainer
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.models import normalizing_flow as tnf
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

torch.set_num_threads(2)

NARROW = dict(
    dynedge_layer_sizes=((16, 32), (24, 32)),
    post_processing_layer_sizes=(24, 16),
    readout_layer_sizes=(8,),
)
RTOL = 2e-4


def _events(rng, B, lo=6, hi=16):
    # unit-scale pulses (as the JAX flow tests use): the narrow random
    # DynEdge's latents stay small, so the NLLH is well conditioned
    return [rng.standard_normal((int(rng.integers(lo, hi + 1)), 4)).astype(
        np.float32) for _ in range(B)]


def _unit(rng, n):
    v = rng.standard_normal((n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _batches(seed, sizes, L=16):
    """The same batches for both packages, with an energy, a second
    scalar and a direction label."""
    rng = np.random.default_rng(seed)
    jbs, tbs = [], []
    for B in sizes:
        events = _events(rng, B)
        labels = {"energy": rng.normal(1.5, 0.7, B).astype(np.float32),
                  "zenith": rng.uniform(0, 3, B).astype(np.float32),
                  "direction": _unit(rng, B)}
        jbs.append(jax_make_batch(events, labels=labels, length=L))
        tbs.append(make_batch(events, labels=labels, length=L))
    return jbs, tbs


def _perturbed(params, seed, scale=0.3):
    """The JAX parameters with every leaf moved by noise, so the
    zero-initialised conditioner heads are not zero."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape)
                   * (1.0 if a.ndim < 2 else 1.0 / np.sqrt(a.shape[0]))
                   ).astype(np.float32),
        jax.device_get(params))


def _flow_pair(kind, seed=0, **kwargs):
    """A JAX density, its perturbed parameters, and the port's density
    holding them."""
    jbs, tbs = _batches(seed, [5])
    if kind == "spherical":
        jflow = jnf.SphericalFlow(backbone=JaxDynEdge(nb_inputs=4, **NARROW),
                                  **kwargs)
        tflow = tnf.SphericalFlow(DynEdge(nb_inputs=4, **NARROW), device="cpu",
                                  **kwargs)
    else:
        jflow = jnf.NormalizingFlow(backbone=JaxDynEdge(nb_inputs=4, **NARROW),
                                    transform=kind, **kwargs)
        tflow = tnf.NormalizingFlow(DynEdge(nb_inputs=4, **NARROW),
                                    transform=kind, device="cpu", **kwargs)
    params = _perturbed(jflow.init(jax.random.PRNGKey(seed), jbs[0]), seed + 1)
    tflow.load_state_dict(params_from_jax(params, tflow.state_dict()))
    return jflow, params, tflow, jbs[0], tbs[0]


def _close(got, exp, rtol=RTOL, msg=""):
    exp = np.asarray(exp)
    np.testing.assert_allclose(np.asarray(got), exp, rtol=rtol,
                               atol=rtol * max(np.abs(exp).max(), 1e-6),
                               err_msg=msg)


# ----------------------------------------------------------- the spline
def test_spline_round_trip_and_logdet_match_jax():
    """The rational-quadratic spline's forward and inverse, and their
    log-determinants, against the JAX functions on the same raw
    parameters; forward then inverse is the identity, the log-determinants
    cancel, the tails are the identity."""
    K, bound = 8, 4.0
    rng = np.random.default_rng(0)
    raw = np.broadcast_to(rng.standard_normal((1, 3 * K - 1)).astype(np.float32),
                          (64, 3 * K - 1)).copy()
    z = np.concatenate([rng.uniform(-3.9, 3.9, 60),
                        [-7.0, 7.0, -4.5, 5.5]]).astype(np.float32)
    jx, jld = jnf._rqs_forward_and_logdet(jnp.asarray(z), jnp.asarray(raw), K, bound)
    x, ld_f = tnf._rqs_forward_and_logdet(torch.from_numpy(z), torch.from_numpy(raw),
                                          K, bound)
    _close(x, jx, msg="forward")
    _close(ld_f, jld, msg="forward logdet")
    jz, jli = jnf._rqs_inverse_and_logdet(jx, jnp.asarray(raw), K, bound)
    z2, ld_i = tnf._rqs_inverse_and_logdet(x, torch.from_numpy(raw), K, bound)
    _close(z2, jz, msg="inverse")
    _close(ld_i, jli, msg="inverse logdet")
    np.testing.assert_allclose(z2.numpy(), z, atol=2e-4)
    np.testing.assert_allclose((ld_f + ld_i).numpy(), 0.0, atol=2e-4)
    np.testing.assert_array_equal(x[-4:].numpy(), z[-4:])
    assert (np.diff(x.numpy()[np.argsort(z)]) > 0).all()


# ------------------------------------------------------------ the flows
@pytest.mark.parametrize("transform", ["sinh_arcsinh", "spline"])
def test_normalizing_flow_nllh_and_log_prob_match_jax(transform):
    jflow, params, tflow, jb, tb = _flow_pair(
        transform, nb_targets=2, target_labels=("energy", "zenith"), n_layers=2)
    _close(tflow(tb).detach(), jflow.apply(params, jb), msg="nllh")
    y = np.random.default_rng(5).normal(1.0, 1.2, (5, 2)).astype(np.float32)
    _close(tflow.log_prob(tb, torch.from_numpy(y)).detach(),
           jflow.log_prob(params, jb, jnp.asarray(y)), msg="log_prob")
    assert tflow.prediction_labels == ["energy_nllh", "zenith_nllh"]
    assert tflow.tasks == ()


@pytest.mark.parametrize("transform", ["sinh_arcsinh", "spline"])
def test_normalizing_flow_draws_match_jax(transform):
    """The JAX flow's draws from a key against the port's transform of
    the same standard-normal base draws; ``sample`` draws from the
    explicit generator (the same draws for the same seed)."""
    jflow, params, tflow, jb, tb = _flow_pair(transform, seed=3,
                                             target_labels=("energy",))
    key = jax.random.PRNGKey(7)
    exp = jflow.sample(params, jb, key, n_samples=16)
    z = np.array(jax.random.normal(key, (5, 16, 1)))
    with torch.no_grad():
        got = tflow.transform_base(tflow._raw(tb), torch.from_numpy(z))
        a = tflow.sample(tb, torch.Generator().manual_seed(1), n_samples=16)
        b = tflow.sample(tb, torch.Generator().manual_seed(1), n_samples=16)
    _close(got, exp, msg="draws")
    assert a.shape == (5, 16, 1) and torch.equal(a, b)


def test_normalizing_flow_log_prob_on_a_grid_of_101_targets():
    """The example's density scan: 101 targets, each event's density
    against the JAX flow's; and a new spline flow (the identity: the
    standard normal) integrates to 1 over [-8, 8]."""
    jflow, params, tflow, jb, tb = _flow_pair("spline", seed=4,
                                             target_labels=("energy",))
    grid = np.linspace(-1.0, 4.0, 101, dtype=np.float32)
    for g in grid[::10]:
        y = np.full((5, 1), g, np.float32)
        _close(tflow.log_prob(tb, torch.from_numpy(y)).detach(),
               jflow.log_prob(params, jb, jnp.asarray(y)), msg=f"y={g}")
    fresh = tnf.NormalizingFlow(DynEdge(nb_inputs=4, **NARROW),
                                target_labels=("energy",), transform="spline",
                                device="cpu")
    wide = np.linspace(-8, 8, 801, dtype=np.float32)
    with torch.no_grad():
        p = np.stack([np.exp(fresh.log_prob(tb, torch.full((5, 1), float(v))
                                            ).numpy()) for v in wide])
    np.testing.assert_allclose(np.trapezoid(p, wide, axis=0), 1.0, atol=1e-3)


def test_spherical_flow_matches_jax():
    jflow, params, tflow, jb, tb = _flow_pair("spherical", seed=6,
                                             n_components=4)
    _close(tflow(tb).detach(), jflow.apply(params, jb), msg="nllh")
    y = _unit(np.random.default_rng(8), 5)
    _close(tflow.log_prob(tb, torch.from_numpy(y)).detach(),
           jflow.log_prob(params, jb, jnp.asarray(y)), msg="log_prob")
    _close(tflow.mean_direction(tb).detach(),
           jflow.mean_direction(params, jb), msg="mean_direction")
    np.testing.assert_allclose(
        tnf.anchor_directions(4), np.asarray(jnf.SphericalFlow._anchor_directions(4)))


def test_flow_parameters_round_trip_through_the_jax_tree():
    """``params_to_jax`` of a port flow is the JAX flow's tree, leaf for
    leaf (names and shapes; the conditioner's values bit for bit, the
    backbone's within rounding, as its EdgeConv kernels are carried in
    the port's layout), and ``params_from_jax`` raises on a missing or
    unused leaf."""
    jflow, params, tflow, jb, tb = _flow_pair("spline", seed=9)
    back = params_to_jax(tflow.state_dict())
    flat_j = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_leaves_with_path(params)}
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_leaves_with_path(back)}
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        if "backbone" in k:
            np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)
    cut = jax.tree_util.tree_map(lambda a: a, back)
    del cut["params"]["cond_1"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(cut, tflow.state_dict())
    extra = jax.tree_util.tree_map(lambda a: a, back)
    extra["params"]["cond_2"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="unused"):
        params_from_jax(extra, tflow.state_dict())


@pytest.mark.parametrize("kind", ["sinh_arcsinh", "spherical"])
def test_trainer_fit_and_predict_match_jax(kind):
    """Two epochs of ``Trainer.fit`` with validation from the same
    initial parameters: the losses within 1e-4 of the JAX Trainer's;
    ``predict`` gives the per-event NLLH as one ``[N, 1]`` array, and
    ``predict_as_dataframe`` the JAX frame's columns."""
    kwargs = ({} if kind == "spherical" else
              dict(transform=kind, target_labels=("energy",)))
    jtrain, ttrain = _batches(21, [4, 5, 4])
    jval, tval = _batches(22, [3, 4])
    if kind == "spherical":
        jflow = jnf.SphericalFlow(backbone=JaxDynEdge(nb_inputs=4, **NARROW),
                                  n_components=4)
        tflow = tnf.SphericalFlow(DynEdge(nb_inputs=4, **NARROW),
                                  n_components=4, device="cpu")
    else:
        jflow = jnf.NormalizingFlow(backbone=JaxDynEdge(nb_inputs=4, **NARROW),
                                    **kwargs)
        tflow = tnf.NormalizingFlow(DynEdge(nb_inputs=4, **NARROW),
                                    device="cpu", **kwargs)
    jtrainer = JaxTrainer(jflow, learning_rate=1e-3)
    jtrainer.init(jtrain[0])
    tflow.load_state_dict(params_from_jax(
        jax.device_get(jtrainer.state.params), tflow.state_dict()))
    j_hist = jtrainer.fit(jtrain, jval, max_epochs=2)
    trainer = Trainer(tflow, learning_rate=1e-3)
    hist = trainer.fit(ttrain, tval, max_epochs=2)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], j_hist[key], rtol=1e-4, err_msg=key)
    got, = trainer.predict(tval)
    exp, = jtrainer.predict(jval)
    assert got.shape == (7, 1)
    _close(got, exp, rtol=1e-4, msg="predict")
    df, jdf = (trainer.predict_as_dataframe(tval, ["energy"]),
               jtrainer.predict_as_dataframe(jval, ["energy"]))
    assert list(df.columns) == list(jdf.columns)
    _close(df.to_numpy(), jdf.to_numpy(), rtol=1e-4, msg="predict_as_dataframe")


def test_weighted_flow_loss_reads_the_event_weights():
    """``loss_from_batch`` weights the NLLH by ``event_weight`` as the
    JAX flow does."""
    jflow, params, tflow, jb, tb = _flow_pair("sinh_arcsinh", seed=12,
                                             target_labels=("energy",))
    w = np.linspace(0.5, 1.5, 5).astype(np.float32)
    jb = jb.replace(event_weight=jnp.asarray(w))
    tb.event_weight = torch.from_numpy(w)
    exp = jflow.loss_from_batch(jflow.apply(params, jb), jb)
    got = tflow.loss_from_batch(tflow(tb), tb)
    _close(got.detach(), exp)


def test_flow_example_matches_the_jax_example_path():
    """The port's flow example's pieces (its dataset and its flow on the
    bundled database) against the JAX example's: the same targets and,
    from the same parameters, the same density scan."""
    from graphnet_tpu.data.dataloader import DataLoader as JaxDataLoader
    from graphnet_tpu_torch.data.dataloader import DataLoader
    from graphnet_tpu_torch.examples import train_normalizing_flow as ex
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "03_training", "06_train_normalizing_flow.py")
    spec = importlib.util.spec_from_file_location("jax_flow_example", path)
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)

    args = ex.parse_args(["--device", "cpu"])
    dataset, _ = ex.build(args)
    flow = tnf.NormalizingFlow(DynEdge(nb_inputs=4, **NARROW),
                               target_labels=("log10_energy",), device="cpu")
    from graphnet_tpu.constants import EXAMPLE_SQLITE_DATA
    from graphnet_tpu.data.constants import FEATURES, TRUTH
    from graphnet_tpu.data.sqlite_dataset import SQLiteDataset
    from graphnet_tpu.models.detector.prometheus import Prometheus
    from graphnet_tpu.models.graphs import KNNGraph

    jds = SQLiteDataset(path=EXAMPLE_SQLITE_DATA,
                        graph_definition=KNNGraph(detector=Prometheus()),
                        pulsemaps="total", features=FEATURES.PROMETHEUS,
                        truth=TRUTH.PROMETHEUS, truth_table="mc_truth",
                        labels={"log10_energy": jex.Log10Energy()})
    jflow = jnf.NormalizingFlow(backbone=JaxDynEdge(nb_inputs=4, **NARROW),
                                target_labels=("log10_energy",))
    jb = next(iter(JaxDataLoader(jds, batch_size=4))).unpacked()
    tb = next(iter(DataLoader(dataset, batch_size=4)))
    np.testing.assert_array_equal(tb.labels["log10_energy"].numpy(),
                                  np.asarray(jb.labels["log10_energy"]))
    params = _perturbed(jflow.init(jax.random.PRNGKey(0), jb), 2, scale=0.1)
    flow.load_state_dict(params_from_jax(params, flow.state_dict()))
    logp = ex.density_scan(flow, tb)
    exp = np.stack([np.asarray(jflow.log_prob(params, jb, jnp.full((4, 1), g)))
                    for g in ex.GRID[::20]])
    _close(logp[::20], exp)
