"""The port's DynEdgeTITO direction model against the JAX package on the
CPU: the backbone, the direction task, the von Mises-Fisher loss and
``log_cmk``, gradients, ``Trainer.fit``, ``DeploymentModule`` and the
parameter carry-over."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.deployment.deployment_module import (
    DeploymentModule as JaxDeploymentModule,
)
from graphnet_tpu.models.gnn.dynedge_kaggle_tito import DynEdgeTITO as JaxTITO
from graphnet_tpu.models.graphs.graph_definition import Event as JaxEvent
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    DirectionReconstructionWithKappa as JaxDirection,
)
from graphnet_tpu.training import loss_functions as jlf
from graphnet_tpu.training.trainer import Trainer as JaxTrainer
from graphnet_tpu.utils.config import save_model_config
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
from graphnet_tpu_torch.models.gnn.dynedge_kaggle_tito import DynEdgeTITO
from graphnet_tpu_torch.models.graphs.graph_definition import Event
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import (
    DirectionReconstructionWithKappa,
)
from graphnet_tpu_torch.ops.knn import knn_graph
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

torch.set_num_threads(2)

# two blocks, two heads of dim 32 (the flash kernels' head dim), a
# feed-forward of the default 2048
NARROW = dict(
    dyntrans_layer_sizes=((64, 64), (64, 64)),
    n_head=2,
    post_processing_layer_sizes=(48, 32),
    readout_layer_sizes=(32, 16),
)
FEATURES = ["sensor_pos_x", "sensor_pos_y", "sensor_pos_z", "t"]
L = 64


def _events(rng, lengths):
    return [
        (rng.standard_normal((int(n), 4)) * [50, 50, 50, 5]).astype(np.float32)
        for n in lengths
    ]


def _directions(rng, B):
    d = rng.standard_normal((B, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _batches(seed, lengths_per_batch):
    rng = np.random.default_rng(seed)
    jbs, tbs = [], []
    for lengths in lengths_per_batch:
        events = _events(rng, lengths)
        labels = {"direction": _directions(rng, len(lengths))}
        jbs.append(jax_make_batch(events, labels=labels, length=L))
        tbs.append(make_batch(events, labels=labels, length=L))
    return jbs, tbs


def _jax_model(**kw):
    return JaxStandardModel(
        backbone=JaxTITO(nb_inputs=4, **NARROW, **kw),
        tasks=(JaxDirection(loss_function=jlf.VonMisesFisher3DLoss()),),
    )


def _port_model(params, compute_dtype=None):
    model = StandardModel(
        DynEdgeTITO(nb_inputs=4, compute_dtype=compute_dtype, **NARROW),
        [DirectionReconstructionWithKappa(
            hidden_size=16, loss_function=tlf.VonMisesFisher3DLoss())],
        device="cpu",
    )
    if params is not None:
        model.load_state_dict(params_from_jax(params, model.state_dict()))
    return model


def _random_tree(shapes, seed):
    """Random parameters of the tree's shapes, biases and norm scales
    included.  With the zero biases of ``init`` an event of one pulse (no
    edge) sends exact zeros through every layer norm of the blocks, where
    the gradient is ill-conditioned (~1e10 in both packages)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.5
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


@pytest.fixture(scope="module")
def narrow():
    """The JAX model, random parameters and a batch of 3 events: 40
    pulses, 0 pulses (a padding event: every attention row fully masked)
    and 1 pulse (a node with no edge)."""
    jbs, tbs = _batches(0, [[40, 0, 1]])
    jmodel = _jax_model()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jbs[0])
    return jmodel, _random_tree(shapes, 0), jbs[0], tbs[0]


def test_narrow_tito_latents_predictions_and_grads_match_jax(narrow):
    jmodel, params, jb, tb = narrow

    def loss_fn(p):
        outs = jmodel.apply(p, jb)
        return jmodel.loss_from_batch(outs, jb), outs[0][0]

    (j_loss, j_pred), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    j_lat = np.asarray(
        jmodel.backbone.apply({"params": params["params"]["backbone"]}, jb)
    )
    model = _port_model(params)
    lat = model.backbone(tb)
    outs = model(tb)
    loss = model.loss_from_batch(outs, tb)
    loss.backward()
    assert lat.shape == (3, 16) and outs[0][0].shape == (3, 4)
    np.testing.assert_allclose(lat.detach().numpy(), j_lat, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(outs[0][0].detach().numpy(), np.asarray(j_pred),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=2e-4)
    exp = params_from_jax(jax.device_get(j_grads), model.state_dict())
    assert len(exp) == len(list(model.parameters())) == 48
    for name, p in model.named_parameters():
        e = exp[name].numpy()
        assert p.grad is not None and np.abs(e).max() > 0, name
        np.testing.assert_allclose(
            p.grad.numpy(), e, rtol=2e-4, atol=2e-5 * np.abs(e).max(),
            err_msg=name,
        )


def test_tito_static_edges_from_the_batch(narrow):
    """Edges the batch carries are used as they are; the kNN otherwise
    runs on x, y, z, t (D=4)."""
    _, params, _, tb = narrow
    model = _port_model(params).eval()
    idx, em = knn_graph(tb.x[..., :4], tb.mask, k=8)
    tb2 = make_batch([tb.x[0, :40].numpy(), np.zeros((0, 4), np.float32),
                      tb.x[2, :1].numpy()], labels=tb.labels, length=L)
    tb2.edges, tb2.edge_mask = idx, em
    with torch.no_grad():
        np.testing.assert_array_equal(model(tb)[0][0].numpy(),
                                      model(tb2)[0][0].numpy())
        tb2.edge_mask = torch.zeros_like(em)
        assert not np.array_equal(model(tb)[0][0].numpy(),
                                  model(tb2)[0][0].numpy())


def test_tito_bf16_runs_near_fp32(narrow):
    _, params, _, tb = narrow
    m32, m16 = _port_model(params), _port_model(params, "bfloat16")
    lat32 = m32.backbone(tb)
    lat16 = m16.backbone(tb)
    assert lat16.dtype == torch.float32 and torch.isfinite(lat16).all()
    err = float(((lat16 - lat32).abs().max() / lat32.abs().max()).detach())
    assert err < 5e-2, err
    loss = m16.loss_from_batch(m16(tb), tb)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in m16.parameters())


def test_tito_rejects_dropout_and_empty_pooling():
    # dropout is ported: deterministic it builds and is the identity
    # (tests/test_torch_stochastic.py holds it on against the JAX package)
    tito = DynEdgeTITO(nb_inputs=4, dropout_rate=0.1, **NARROW)
    assert not tito.conv_0.transformer.drop.active
    with pytest.raises(AssertionError, match="pooling"):
        DynEdgeTITO(nb_inputs=4, global_pooling_schemes=(), **NARROW)


@pytest.mark.parametrize(
    "options",
    [dict(use_global_features=False),
     dict(use_post_processing_layers=False, global_pooling_schemes=("max", "mean")),
     dict(deterministic=False)],
    ids=["no_global_features", "no_post_processing_two_pools",
         "not_deterministic_without_dropout"],
)
def test_tito_options_match_jax(options):
    jbs, tbs = _batches(1, [[20, 9]])
    jmodel = _jax_model(**options)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(2), jbs[0]))
    exp = np.asarray(jmodel.apply(params, jbs[0], inference=True)[0][0])
    model = StandardModel(
        DynEdgeTITO(nb_inputs=4, **NARROW, **options),
        [DirectionReconstructionWithKappa(hidden_size=16)], device="cpu",
    )
    model.load_state_dict(params_from_jax(params, model.state_dict()))
    with torch.no_grad():
        got = model(tbs[0], inference=True)[0][0].numpy()
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-5)


# ------------------------------------------------------ task and losses
KAPPAS = np.array([0.01, 0.09, 0.11, 0.5, 5.0, 60.0, 99.9, 100.0, 100.1, 400.0],
                  np.float32)


@pytest.mark.parametrize("m", [2, 3])
def test_log_cmk_matches_jax_across_the_switch(m):
    exp = np.asarray(jlf.log_cmk(m, jnp.asarray(KAPPAS)))
    exp_g = np.asarray(jax.grad(lambda k: jnp.sum(jlf.log_cmk(m, k)))(jnp.asarray(KAPPAS)))
    k = torch.from_numpy(KAPPAS).requires_grad_()
    got = tlf.log_cmk(m, k)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), exp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(k.grad.numpy(), exp_g, rtol=1e-5, atol=1e-5)
    for name in ("log_cmk_exact", "log_cmk_approx"):
        np.testing.assert_allclose(
            getattr(tlf, name)(m, torch.from_numpy(KAPPAS)).numpy(),
            np.asarray(getattr(jlf, name)(m, jnp.asarray(KAPPAS))),
            rtol=1e-5, atol=1e-5, err_msg=name,
        )
    # other m take the log I_nu series (m = 5 here, more in
    # tests/test_torch_targets.py)
    np.testing.assert_allclose(
        tlf.log_cmk_exact(5, torch.from_numpy(KAPPAS)).numpy(),
        np.asarray(jlf.log_cmk_exact(5, jnp.asarray(KAPPAS))),
        rtol=2e-4, atol=1e-5, err_msg="log_cmk_exact(5)")


def test_direction_task_and_vmf3d_loss_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 3)) * [[1], [3], [10], [30], [60], [0.05]]).astype(np.float32)
    target = _directions(rng, 6)
    w = rng.random(6).astype(np.float32)
    jtask = JaxDirection(loss_function=jlf.VonMisesFisher3DLoss())
    ttask = DirectionReconstructionWithKappa(
        hidden_size=3, loss_function=tlf.VonMisesFisher3DLoss())
    assert ttask.predictions == jtask.predictions and ttask.targets == ("direction",)
    j_pred, _ = jtask._forward(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    t_pred, reg = ttask._forward(xt)
    assert float(reg) == 0.0
    np.testing.assert_allclose(t_pred.detach().numpy(), np.asarray(j_pred), rtol=1e-6)

    def jloss(x, weights):
        pred, _ = jtask._forward(x)
        return jtask.compute_loss(pred, jnp.float32(0.0),
                                  {"direction": jnp.asarray(target)}, weights=weights)

    for weights in (None, w):
        exp, exp_g = jax.value_and_grad(jloss)(
            jnp.asarray(x), None if weights is None else jnp.asarray(weights))
        xt.grad = None
        pred, reg = ttask._forward(xt)
        got = ttask.compute_loss(pred, reg, {"direction": torch.from_numpy(target)},
                                 weights=None if weights is None else torch.from_numpy(weights))
        got.backward()
        np.testing.assert_allclose(got.item(), float(exp), rtol=1e-5)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(exp_g), rtol=1e-5, atol=1e-6)


# ----------------------------------------------- Trainer and deployment
def test_trainer_fit_tito_matches_jax():
    """2 epochs of 2 ragged batches with validation, the default
    schedule, from the same initial parameters."""
    jtrain, ttrain = _batches(5, [[30, 12, 2], [25, 40, 8]])
    jval, tval = _batches(6, [[20, 0, 33]])
    jtrainer = JaxTrainer(_jax_model(), learning_rate=1e-2)
    jtrainer.init(jtrain[0])
    params0 = jax.device_get(jtrainer.state.params)
    j_hist = jtrainer.fit(jtrain, jval, max_epochs=2)
    trainer = Trainer(_port_model(params0), learning_rate=1e-2)
    hist = trainer.fit(ttrain, tval, max_epochs=2)
    assert trainer.step == 4
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], j_hist[key], rtol=1e-4, err_msg=key)
    # Adam moves each entry by up to ~lr a step whatever its gradient's
    # size, so an entry whose gradient is near 0 (or routed by a near tie
    # of the max aggregation) carries the rounding of g / sqrt(v): the
    # absolute floor is 1e-3 of the base rate
    exp = params_from_jax(jax.device_get(jtrainer.state.params), trainer.model.state_dict())
    for name, value in trainer.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), exp[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_deployment_module_tito_matches_jax(tmp_path, narrow):
    jmodel, params, _, _ = narrow
    config, pkl = str(tmp_path / "model.yml"), str(tmp_path / "state_dict.pkl")
    save_model_config(jmodel, config)
    trainer = Trainer(_port_model(params))
    trainer.save_state_dict(pkl)  # the port writes the JAX Trainer's file
    jax_module = JaxDeploymentModule(config, pkl)
    module = DeploymentModule(_port_model(None), pkl, device="cpu")
    assert module.prediction_columns == jax_module.prediction_columns
    arrays = _events(np.random.default_rng(7), [12, 0, 30, 1, 3])
    got = module([Event(x=a, features=FEATURES) for a in arrays])
    exp = jax_module([JaxEvent(x=a, features=FEATURES) for a in arrays])
    assert got.shape == (5, 4)
    assert np.isnan(got[1]).all() and np.isfinite(np.delete(got, 1, 0)).all()
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-5)


def test_params_round_trip_full_width_tito():
    """The full-width TITO tree (``eval_shape``: no compile) carried over
    and back; a missing or unused leaf raises."""
    jmodel = JaxStandardModel(
        backbone=JaxTITO(nb_inputs=4),
        tasks=(JaxDirection(loss_function=jlf.VonMisesFisher3DLoss()),),
    )
    batch = jax_make_batch(_events(np.random.default_rng(8), [5, 9]), length=16)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(9)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = StandardModel(
        DynEdgeTITO(nb_inputs=4),
        [DirectionReconstructionWithKappa(hidden_size=128)], device="cpu")
    sd = params_from_jax(tree, model.state_dict())
    assert len(sd) == len(model.state_dict()) == len(jax.tree_util.tree_leaves(tree)) == 86
    model.load_state_dict(sd)
    block = tree["params"]["backbone"]["conv_3"]
    assert block["transformer"]["mha"]["qkv"]["kernel"].shape == (256, 768)
    np.testing.assert_array_equal(
        sd["backbone.conv_3.transformer.mha.qkv.weight"].numpy(),
        block["transformer"]["mha"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(sd["backbone.conv_3.norm1.weight"].numpy(),
                                  block["norm1"]["scale"])
    assert sd["backbone.readout.dense_0.weight"].shape == (256, 265)
    assert sd["tasks_0.affine.weight"].shape == (3, 128)
    back = params_to_jax(model.state_dict())
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, tree))
    missing = jax.tree_util.tree_map(lambda a: a, tree)
    del missing["params"]["backbone"]["conv_1"]["transformer"]["norm2"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, model.state_dict())
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["params"]["backbone"]["conv_0"]["transformer"]["norm3"] = {"scale": np.ones(256)}
    with pytest.raises(ValueError, match="unused"):
        params_from_jax(extra, model.state_dict())
