"""The port's training path against the JAX package on the CPU: losses,
the task loss, a narrow DynEdge's loss and gradients, StandardModel's
``edge_definition``, ``Trainer.fit``, the ``state_dict.pkl`` round trip
and gradient clipping."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.deployment.deployment_module import (
    DeploymentModule as JaxDeploymentModule,
)
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models.graphs.edges import MinkowskiKNNEdges as JaxMinkowskiKNNEdges
from graphnet_tpu.models.graphs.graph_definition import Event as JaxEvent
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    EnergyReconstruction as JaxEnergy,
)
from graphnet_tpu.training import loss_functions as jlf
from graphnet_tpu.training.trainer import Trainer as JaxTrainer
from graphnet_tpu.utils.config import TRANSFORM_REGISTRY, save_model_config
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.graphs.edges import KNNEdges
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.training.callbacks import piecewise_linear_schedule
from graphnet_tpu_torch.training.trainer import Trainer, clip_by_global_norm
from graphnet_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

torch.set_num_threads(2)

NARROW = dict(
    dynedge_layer_sizes=((16, 32), (24, 32)),
    post_processing_layer_sizes=(24, 16),
    readout_layer_sizes=(8,),
)
FEATURES = ["sensor_pos_x", "sensor_pos_y", "sensor_pos_z", "t"]


def _events(rng, B, lo=6, hi=16):
    return [
        (rng.standard_normal((int(rng.integers(lo, hi + 1)), 4)) * [50, 50, 50, 5])
        .astype(np.float32)
        for _ in range(B)
    ]


def _energies(rng, B):
    return np.abs(rng.standard_normal(B) * 100 + 200).astype(np.float32)


def _batches(seed, sizes, L=16):
    """The same ragged batches (sizes and lengths) for both packages."""
    rng = np.random.default_rng(seed)
    jbs, tbs = [], []
    for B in sizes:
        events, labels = _events(rng, B), {"total_energy": _energies(rng, B)}
        jbs.append(jax_make_batch(events, labels=labels, length=L))
        tbs.append(make_batch(events, labels=labels, length=L))
    return jbs, tbs


def _jax_model():
    return JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4, **NARROW),
        tasks=(
            JaxEnergy(
                loss_function=jlf.LogCoshLoss(),
                target_labels=("total_energy",),
                transform_prediction_and_target=TRANSFORM_REGISTRY["log10"],
            ),
        ),
    )


def _port_model(params):
    model = StandardModel(
        DynEdge(nb_inputs=4, **NARROW),
        [
            EnergyReconstruction(
                hidden_size=8,
                loss_function=tlf.LogCoshLoss(),
                target_labels=("total_energy",),
                transform_prediction_and_target=torch.log10,
            )
        ],
        device="cpu",
    )
    model.load_state_dict(params_from_jax(params, model.state_dict()))
    return model


def _assert_params_close(model, tree, rtol, atol_of_max):
    """Every port parameter against the JAX tree's (carried over)."""
    exp = params_from_jax(jax.device_get(tree), model.state_dict())
    for name, value in model.state_dict().items():
        e = exp[name].numpy()
        np.testing.assert_allclose(
            value.detach().numpy(), e, rtol=rtol,
            atol=atol_of_max * max(np.abs(e).max(), 1e-30), err_msg=name,
        )


# --------------------------------------------------------------- losses
@pytest.mark.parametrize("name", ["LogCoshLoss", "MSELoss", "RMSELoss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(3)
    pred = (rng.standard_normal((6, 1)) * 3).astype(np.float32)
    target = (rng.standard_normal((6, 1)) * 3).astype(np.float32)
    w = rng.random(6).astype(np.float32)
    jloss, tloss = getattr(jlf, name)(), getattr(tlf, name)()
    tp, tt, tw = map(torch.from_numpy, (pred, target, w))
    jp, jt, jw = map(jnp.asarray, (pred, target, w))
    for kw_t, kw_j in (({}, {}), ({"weights": tw}, {"weights": jw})):
        np.testing.assert_allclose(
            tloss(tp, tt, **kw_t).numpy(), np.asarray(jloss(jp, jt, **kw_j)),
            rtol=1e-6,
        )
        # [B] weights against [B, 1] elements pair per event
        el_t = tloss(tp, tt, return_elements=True, **kw_t)
        el_j = jloss(jp, jt, return_elements=True, **kw_j)
        assert tuple(el_t.shape) == el_j.shape
        np.testing.assert_allclose(el_t.numpy(), np.asarray(el_j), rtol=1e-6)
    # log cosh stays finite far out, where cosh overflows
    big = torch.tensor([[200.0], [-200.0]])
    assert torch.isfinite(tlf.LogCoshLoss()(big, torch.zeros(2), return_elements=True)).all()


def test_node_level_loss_matches_jax():
    rng = np.random.default_rng(5)
    B, L = 3, 8
    pred = rng.standard_normal((B, L, 1)).astype(np.float32)
    truth = rng.standard_normal((B, L)).astype(np.float32)
    mask = rng.random((B, L)) > 0.3
    ew = np.array([1.5, 1.5, 0.0], np.float32)
    jtask = JaxEnergy(
        loss_function=jlf.LogCoshLoss(), target_labels=("noise",), node_level=True
    )
    ttask = EnergyReconstruction(
        hidden_size=4, loss_function=tlf.LogCoshLoss(),
        target_labels=("noise",), node_level=True,
    )
    for event_weights in (None, ew):
        exp = jtask.compute_loss(
            jnp.asarray(pred), jnp.float32(0.0), {},
            node_labels={"noise": jnp.asarray(truth)}, mask=jnp.asarray(mask),
            event_weights=None if event_weights is None else jnp.asarray(event_weights),
        )
        got = ttask.compute_loss(
            torch.from_numpy(pred), torch.zeros(()), {},
            node_labels={"noise": torch.from_numpy(truth)},
            mask=torch.from_numpy(mask),
            event_weights=None if event_weights is None else torch.from_numpy(event_weights),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6)


def test_event_loss_weight_label_matches_jax():
    rng = np.random.default_rng(6)
    pred = (rng.random((4, 1)) * 3 + 1).astype(np.float32)
    labels = {"total_energy": _energies(rng, 4), "w": rng.random(4).astype(np.float32)}
    jtask = JaxEnergy(
        loss_function=jlf.MSELoss(), target_labels=("total_energy",),
        transform_prediction_and_target=TRANSFORM_REGISTRY["log10"], loss_weight="w",
    )
    ttask = EnergyReconstruction(
        hidden_size=4, loss_function=tlf.MSELoss(), target_labels=("total_energy",),
        transform_prediction_and_target=torch.log10, loss_weight="w",
    )
    ew = np.array([1.0, 2.0, 0.5, 0.0], np.float32)
    exp = jtask.compute_loss(
        jnp.asarray(pred), jnp.float32(0.0),
        {k: jnp.asarray(v) for k, v in labels.items()}, event_weights=jnp.asarray(ew),
    )
    got = ttask.compute_loss(
        torch.from_numpy(pred), torch.zeros(()),
        {k: torch.from_numpy(v) for k, v in labels.items()},
        event_weights=torch.from_numpy(ew),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6)
    with pytest.raises(KeyError, match="not found"):
        ttask.compute_loss(torch.from_numpy(pred), torch.zeros(()), {"w": labels["w"]})


# ------------------------------------------------------ model gradients
def test_narrow_dynedge_loss_and_grads_match_jax():
    jbs, tbs = _batches(7, [5])
    jmodel = _jax_model()
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jbs[0]))

    def loss_fn(p):
        return jmodel.loss_from_batch(jmodel.apply(p, jbs[0]), jbs[0])

    j_loss, j_grads = jax.value_and_grad(loss_fn)(params)
    model = _port_model(params)
    loss = model.loss_from_batch(model(tbs[0]), tbs[0])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=2e-4)
    exp = params_from_jax(jax.device_get(j_grads), model.state_dict())
    assert len(exp) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        e = exp[name].numpy()
        assert p.grad is not None and np.abs(e).max() > 0, name
        np.testing.assert_allclose(
            p.grad.numpy(), e, rtol=2e-4, atol=2e-5 * np.abs(e).max(),
            err_msg=name,
        )


# ------------------------------------------------------ edge_definition
def _energy_model(**kwargs):
    return StandardModel(
        DynEdge(nb_inputs=4, **NARROW),
        [EnergyReconstruction(hidden_size=8, target_labels=("total_energy",))],
        device="cpu",
        **kwargs,
    )


def test_edge_definition_none_keeps_the_model():
    """``edge_definition=None`` (what every StandardModel config passes)
    builds the model built without it, bit for bit, and that model
    answers as the JAX model with ``edge_definition=None``."""
    jbs, tbs = _batches(10, [5])
    plain, with_none = _energy_model(), _energy_model(edge_definition=None)
    for (name, a), (_, b) in zip(plain.state_dict().items(),
                                 with_none.state_dict().items()):
        assert torch.equal(a, b), name
    out, out_none = plain(tbs[0]), with_none(tbs[0])
    for (p, r), (pn, rn) in zip(out, out_none):
        assert torch.equal(p, pn) and torch.equal(r, rn)

    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4, **NARROW),
        tasks=(JaxEnergy(target_labels=("total_energy",)),),
        edge_definition=None,
    )
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jbs[0]))
    with_none.load_state_dict(params_from_jax(params, with_none.state_dict()))
    j_pred = np.asarray(jmodel.apply(params, jbs[0])[0][0])
    pred = with_none(tbs[0])[0][0].detach().numpy()
    np.testing.assert_allclose(pred, j_pred, rtol=2e-4,
                               atol=2e-5 * np.abs(j_pred).max())


def test_edge_definition_knn_equals_the_model_without_a_rule():
    """``edge_definition=KNNEdges()`` builds the graph the backbone
    builds itself: the same answers, bit for bit."""
    _, tbs = _batches(11, [5])
    plain, ruled = _energy_model(), _energy_model(edge_definition=KNNEdges())
    ruled.load_state_dict(plain.state_dict())
    (p, _), = plain(tbs[0])
    (q, _), = ruled(tbs[0])
    assert torch.equal(p, q)


@pytest.mark.parametrize("rule", ["knn", "minkowski"])
def test_edge_definition_rule_matches_jax(rule):
    """An edge rule evaluated before the backbone, on the JAX model's
    parameters: the port's predictions, loss and gradients against the
    JAX StandardModel with the same rule (rtol 2e-4)."""
    from graphnet_tpu.models.graphs.edges import KNNEdges as JaxKNNEdges
    from graphnet_tpu_torch.models.graphs.edges import MinkowskiKNNEdges

    jbs, tbs = _batches(12, [6])
    jrule, trule = ((JaxKNNEdges(), KNNEdges()) if rule == "knn"
                    else (JaxMinkowskiKNNEdges(), MinkowskiKNNEdges()))
    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4, **NARROW),
        tasks=(JaxEnergy(loss_function=jlf.LogCoshLoss(),
                         target_labels=("total_energy",)),),
        edge_definition=jrule,
    )
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1), jbs[0]))
    model = StandardModel(
        DynEdge(nb_inputs=4, **NARROW),
        [EnergyReconstruction(hidden_size=8, loss_function=tlf.LogCoshLoss(),
                              target_labels=("total_energy",))],
        edge_definition=trule, device="cpu")
    model.load_state_dict(params_from_jax(params, model.state_dict()))

    def jloss(p):
        return jmodel.loss_from_batch(jmodel.apply(p, jbs[0]), jbs[0])

    j_val, j_grad = jax.value_and_grad(jloss)(params)
    j_pred = np.asarray(jmodel.apply(params, jbs[0])[0][0])
    out = model(tbs[0])
    loss = model.loss_from_batch(out, tbs[0])
    loss.backward()
    pred = out[0][0].detach().numpy()
    np.testing.assert_allclose(pred, j_pred, rtol=2e-4,
                               atol=2e-5 * np.abs(j_pred).max())
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=2e-4)
    exp = params_from_jax(jax.device_get(j_grad), model.state_dict())
    for name, p in model.named_parameters():
        e = exp[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), e, rtol=2e-4,
                                   atol=2e-4 * max(np.abs(e).max(), 1e-30),
                                   err_msg=name)


# -------------------------------------------------------------- Trainer
def test_trainer_fit_matches_jax():
    """2 epochs of 3 ragged batches, a validation loader, the default
    schedule, from the same initial parameters."""
    jtrain, ttrain = _batches(8, [4, 5, 4])
    jval, tval = _batches(9, [3, 4])
    jtrainer = JaxTrainer(_jax_model(), learning_rate=1e-2)
    jtrainer.init(jtrain[0])
    params0 = jax.device_get(jtrainer.state.params)
    j_hist = jtrainer.fit(jtrain, jval, max_epochs=2)

    model = _port_model(params0)
    trainer = Trainer(model, learning_rate=1e-2)
    hist = trainer.fit(ttrain, tval, max_epochs=2)
    assert trainer.step == 6
    for key in ("train_loss", "val_loss"):
        assert len(hist[key]) == 2
        np.testing.assert_allclose(hist[key], j_hist[key], rtol=1e-4, err_msg=key)
    _assert_params_close(model, jtrainer.state.params, 1e-4, 1e-5)
    # the canonical schedule: lr at step 6 is back down to 1e-2 of base
    np.testing.assert_allclose(trainer._current_lr(), 1e-4, rtol=1e-6)


def test_schedule_matches_optax_schedule():
    from graphnet_tpu.training.callbacks import piecewise_linear_schedule as jsched

    j = jsched(1e-3, [0, 50, 400], [1e-2, 1.0, 1e-2])
    t = piecewise_linear_schedule(1e-3, [0, 50, 400], [1e-2, 1.0, 1e-2])
    for step in (0, 1, 25, 50, 51, 399, 400, 1000):
        # both interpolate in float32, in another order of operations
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-5)


def test_state_dict_round_trip_and_jax_deployment(tmp_path):
    jbs, tbs = _batches(10, [4])
    jmodel = _jax_model()
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1), jbs[0]))
    assert jax.tree_util.tree_all(
        jax.tree_util.tree_map(
            np.array_equal,
            params,
            params_to_jax(params_from_jax(params)),
        )
    )
    model = _port_model(params)
    trainer = Trainer(model, learning_rate=1e-2)
    trainer.train_step(tbs[0])  # weights the JAX side has not seen
    path, config = str(tmp_path / "state_dict.pkl"), str(tmp_path / "model.yml")
    trainer.save_state_dict(path)
    save_model_config(jmodel, config)
    jax_module = JaxDeploymentModule(config, path)
    rng = np.random.default_rng(11)
    events = _events(rng, 3)
    got = trainer.predict([make_batch(events, length=16)])[0]
    exp = jax_module([JaxEvent(x=e, features=FEATURES) for e in events])
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-5)
    # and the port loads its own file back
    other = _port_model(params)
    Trainer(other).load_state_dict(path)
    for (n, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("max_norm", [0.5, 50.0], ids=["clipped", "kept"])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(12)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_global_norm(params, max_norm)
    exp, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None
    )
    assert (float(norm) > max_norm) == (max_norm == 0.5)
    for p, e in zip(params, exp):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(e), rtol=1e-6)
