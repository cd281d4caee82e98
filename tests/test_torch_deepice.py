"""The port's DeepIce against the JAX package on the CPU: the embeddings,
a narrow model's latents, predictions and gradients on both relative-bias
paths (the JAX kernels in Pallas interpret mode), also with the nested
DynEdge (``include_dynedge``), ``Trainer.fit``, ``DeploymentModule``, the
parameter carry-over at full width and the options (the chunked
bias path against the JAX package's)."""

import copy
import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax

import graphnet_tpu.ops.flash_attention as jfa
from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.deployment.deployment_module import (
    DeploymentModule as JaxDeploymentModule,
)
from graphnet_tpu.models.components import embedding as jemb
from graphnet_tpu.models.gnn.icemix import DeepIce as JaxDeepIce
from graphnet_tpu.models.graphs.graph_definition import Event as JaxEvent
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    DirectionReconstructionWithKappa as JaxDirection,
)
from graphnet_tpu.training import loss_functions as jlf
from graphnet_tpu.training.trainer import Trainer as JaxTrainer
from graphnet_tpu.utils.config import ModelConfig as JaxModelConfig
from graphnet_tpu.utils.config import build as jax_build
from graphnet_tpu.utils.config import save_model_config
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
from graphnet_tpu_torch.models.components import embedding as temb
from graphnet_tpu_torch.models.components.layers import Block, BlockRel
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.gnn.icemix import DeepIce
from graphnet_tpu_torch.models.graphs.graph_definition import Event
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import (
    DirectionReconstructionWithKappa,
)
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.config import ModelConfig, build, load_model
from graphnet_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

torch.set_num_threads(2)

# two rel blocks (the first biased), two blocks, two heads of 16
NARROW = dict(hidden_dim=32, head_size=16, seq_length=32, depth=2, depth_rel=2)
FEATURES = ["x", "y", "z", "t", "charge", "aux"]
L = 128


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Run the JAX flash kernels in interpreter mode (the rel kernels
    take it from the backend themselves)."""
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        jfa.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _events(rng, lengths, n_features=6):
    """IceMix-like pulses: positions ~N(0, 0.5^2), times in [0, 0.03)
    (both sides of the light cone), charge, a 0/1 auxiliary flag."""
    cols = [lambda n: rng.standard_normal((n, 3)) * 0.5,
            lambda n: rng.random((n, 1)) * 0.03,
            lambda n: rng.random((n, 1)),
            lambda n: rng.random((n, 1)) > 0.5]
    return [np.concatenate([c(int(n)) for c in cols], axis=1)[:, :n_features]
            .astype(np.float32) for n in lengths]


def _directions(rng, B):
    d = rng.standard_normal((B, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _batches(seed, lengths_per_batch, n_features=6, length=L):
    rng = np.random.default_rng(seed)
    jbs, tbs = [], []
    for lengths in lengths_per_batch:
        events = _events(rng, lengths, n_features)
        labels = {"direction": _directions(rng, len(lengths))}
        jbs.append(jax_make_batch(events, labels=labels, length=length))
        tbs.append(make_batch(events, labels=labels, length=length))
    return jbs, tbs


def _jax_model(**kw):
    return JaxStandardModel(
        backbone=JaxDeepIce(**{**NARROW, **kw}),
        tasks=(JaxDirection(loss_function=jlf.VonMisesFisher3DLoss()),),
    )


def _port_model(params, **kw):
    model = StandardModel(
        DeepIce(**{**NARROW, **kw}),
        [DirectionReconstructionWithKappa(
            hidden_size=NARROW["hidden_dim"],
            loss_function=tlf.VonMisesFisher3DLoss())],
        device="cpu",
    )
    if params is not None:
        model.load_state_dict(params_from_jax(params, model.state_dict()))
    return model


def _random_tree(shapes, seed):
    """Random parameters of the tree's shapes: dense kernels N(0,
    1/fan_in), every other leaf N(0, 0.5^2) (non-zero biases, norm
    scales, layer scales)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.5
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


@pytest.mark.parametrize(
    "rel_flash,n_features,lengths",
    [("never", 6, [100, 0, 1]), ("always", 6, [100, 0, 1]),
     ("always", 4, [128, 57])],
    ids=["dense_6_features", "kernel_6_features", "kernel_4_features"],
)
def test_narrow_deepice_matches_jax(rel_flash, n_features, lengths):
    """Latents, predictions, the loss and every gradient, rtol 2e-4 with
    an absolute floor of 2e-5 (of each gradient's max).  The events: a
    ragged one, one with 0 pulses (every row of the biased block fully
    masked) and one with 1 pulse; "always" runs the JAX rel kernel in
    Pallas interpret mode and the port's plain versions."""
    jbs, tbs = _batches(0, [lengths], n_features)
    jb, tb = jbs[0], tbs[0]
    jmodel = _jax_model(n_features=n_features, rel_flash=rel_flash)
    params = _random_tree(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jb), 1)

    def loss_fn(p):
        outs = jmodel.apply(p, jb)
        return jmodel.loss_from_batch(outs, jb), outs[0][0]

    (j_loss, j_pred), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    j_lat = np.asarray(
        jmodel.backbone.apply({"params": params["params"]["backbone"]}, jb))
    model = _port_model(params, n_features=n_features, rel_flash=rel_flash)
    assert model.backbone.sandwich_0.attn.uses_rel_kernel(16) == (
        rel_flash == "always")
    lat = model.backbone(tb)
    outs = model(tb)
    loss = model.loss_from_batch(outs, tb)
    loss.backward()
    assert lat.shape == (len(lengths), 32) and outs[0][0].shape == (len(lengths), 4)
    np.testing.assert_allclose(lat.detach().numpy(), j_lat, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(outs[0][0].detach().numpy(), np.asarray(j_pred),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=2e-4)
    exp = params_from_jax(jax.device_get(j_grads), model.state_dict())
    assert len(exp) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        e = exp[name].numpy()
        assert p.grad is not None and np.abs(e).max() > 0, name
        np.testing.assert_allclose(
            p.grad.numpy(), e, rtol=2e-4, atol=2e-5 * np.abs(e).max(),
            err_msg=name)


@pytest.mark.parametrize("rel_flash", ["never", "always"])
def test_narrow_deepice_with_dynedge_matches_jax(rel_flash):
    """``include_dynedge``: the nested DynEdge's node latents (gelu, norm
    layers, k = 5 over x, y, z) beside the Fourier features at half the
    width.  Latents, predictions, the loss and every gradient against
    the JAX package (rtol 2e-4, the floor 2e-5 of each gradient's max) on
    both rel paths; events of 50, 9 and 1 pulses, spread so that no kNN
    distance is near a tie."""
    dyn = dict(nb_inputs=6, nb_neighbours=5,
               dynedge_layer_sizes=((16, 24), (24, 24)),
               post_processing_layer_sizes=(24, 16),
               global_pooling_schemes=None, activation_layer="gelu",
               add_norm_layer=True, skip_readout=True)
    kw = dict(include_dynedge=True, dynedge_args=dyn, rel_flash=rel_flash)
    jbs, tbs = _batches(21, [[50, 9, 1]])
    jb, tb = jbs[0], tbs[0]
    jmodel = _jax_model(**kw)
    params = _random_tree(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jb), 22)

    def loss_fn(p):
        outs = jmodel.apply(p, jb)
        return jmodel.loss_from_batch(outs, jb), outs[0][0]

    (j_loss, j_pred), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = _port_model(params, **kw)
    assert isinstance(model.backbone.dyn_edge, DynEdge)
    outs = model(tb)
    loss = model.loss_from_batch(outs, tb)
    loss.backward()
    np.testing.assert_allclose(outs[0][0].detach().numpy(), np.asarray(j_pred),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=2e-4)
    exp = params_from_jax(jax.device_get(j_grads), model.state_dict())
    assert any(name.startswith("backbone.dyn_edge.") for name in exp)
    for name, p in model.named_parameters():
        e = exp[name].numpy()
        assert p.grad is not None and np.abs(e).max() > 0, name
        np.testing.assert_allclose(
            p.grad.numpy(), e, rtol=2e-4, atol=2e-5 * np.abs(e).max(),
            err_msg=name)


@pytest.mark.parametrize("scaled", [False, True])
def test_embeddings_match_jax(scaled):
    """SinusoidalPosEmb, FourierEncoder (4, 5 and 6 features) and
    SpacetimeEncoder alone, with the same parameters."""
    rng = np.random.default_rng(3)
    x = _events(rng, [40, 40])
    x = np.stack(x)
    n = np.array([40, 17], np.int32)
    t = rng.standard_normal((5, 7)).astype(np.float32) * 3000
    jmod = jemb.SinusoidalPosEmb(dim=32, scaled=scaled)
    params = _random_tree(jax.device_get(jmod.init(jax.random.PRNGKey(0), t)), 4)
    tmod = temb.SinusoidalPosEmb(32, scaled)
    if scaled:
        tmod.scale.data = torch.from_numpy(params["params"]["scale"])
    # the floor: XLA's float32 exp on the CPU rounds 2 of the 16
    # frequencies 1 ulp away from torch's (correctly rounded) ones, and
    # arguments of ~1e4 rad turn that into up to 1.5e-5 (measured)
    np.testing.assert_allclose(tmod(torch.from_numpy(t)).detach().numpy(),
                               np.asarray(jmod.apply(params, t)),
                               rtol=2e-4, atol=5e-5)
    for nf in (4, 5, 6):
        jmod = jemb.FourierEncoder(seq_length=32, output_dim=24, scaled=scaled,
                                   n_features=nf)
        xs = x[..., :nf]
        params = _random_tree(
            jax.device_get(jmod.init(jax.random.PRNGKey(0), xs, n)), 5 + nf)
        tmod = temb.FourierEncoder(32, 24, scaled=scaled, n_features=nf)
        tmod.load_state_dict(params_from_jax(params, tmod.state_dict()))
        got = tmod(torch.from_numpy(xs), torch.from_numpy(n)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(jmod.apply(params, xs, n)),
                                   rtol=2e-4, atol=2e-5, err_msg=f"{nf} features")
    jmod = jemb.SpacetimeEncoder(16)
    params = _random_tree(jax.device_get(jmod.init(jax.random.PRNGKey(0), x)), 12)
    tmod = temb.SpacetimeEncoder(16)
    tmod.load_state_dict(params_from_jax(params, tmod.state_dict()))
    got = tmod(torch.from_numpy(x), torch.from_numpy(x[:, :9])).detach().numpy()
    assert got.shape == (2, 9, 40, 16)
    np.testing.assert_allclose(got, np.asarray(jmod.apply(params, x, x[:, :9])),
                               rtol=2e-4, atol=2e-5)


def test_deepice_bf16_runs_near_fp32():
    _, tbs = _batches(1, [[90, 3]])
    jmodel = _jax_model()
    params = _random_tree(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), _batches(1, [[90, 3]])[0][0]),
        2)
    m32, m16 = _port_model(params), _port_model(params, compute_dtype="bfloat16")
    lat32, lat16 = m32.backbone(tbs[0]), m16.backbone(tbs[0])
    assert lat16.dtype == torch.float32 and torch.isfinite(lat16).all()
    err = float(((lat16 - lat32).abs().max() / lat32.abs().max()).detach())
    assert err < 5e-2, err
    loss = m16.loss_from_batch(m16(tbs[0]), tbs[0])
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in m16.parameters())


def test_deepice_options_not_ported_raise():
    # include_dynedge is ported: the Fourier half width, the nested DynEdge
    model = DeepIce(include_dynedge=True, **NARROW)
    assert model.fourier_ext.mlp_1.out_features == NARROW["hidden_dim"] // 2
    assert model.dyn_edge.nb_outputs == NARROW["hidden_dim"] // 2
    # remat and DropPath are ported: they build, and off they change
    # nothing (tests/test_torch_stochastic.py holds them on)
    assert DeepIce(remat=True, **NARROW).remat
    assert not BlockRel(32, 2, drop_path=0.1).dp1.active
    assert Block(32, 2, drop_path=0.1, deterministic=False).dp2.active
    # the chunked bias path is ported: the JAX DeepIce's latents
    _chunked_latents_match_jax(rel_flash="never", rel_bias_chunks=4)
    # with the rel kernels the chunk count is ignored, as in the JAX package
    DeepIce(rel_flash="auto", rel_bias_chunks=4, **NARROW)
    with pytest.raises(ValueError, match="rel_flash"):
        DeepIce(rel_flash="sometimes", **NARROW)


def test_rel_flash_always_is_auto():
    """The port has no memory rule for "auto" to skip: "always" is its
    alias, and both take the rel kernels exactly where the gate holds
    (an odd head dim fails it: the dense path)."""
    for rel_flash in ("auto", "always"):
        model = DeepIce(rel_flash=rel_flash, **NARROW)
        assert all(getattr(model, f"sandwich_{i}").attn.rel_flash == "auto"
                   for i in range(NARROW["depth_rel"]))
        assert model.sandwich_0.attn.uses_rel_kernel(NARROW["head_size"])
        odd = BlockRel(30, 2, rel_flash=rel_flash)
        assert not odd.attn.uses_rel_kernel(15)
    assert not DeepIce(rel_flash="never", **NARROW).sandwich_0.attn.uses_rel_kernel(16)


def test_scale_leaf_carried_by_the_model_layout():
    """A ``scale`` leaf keeps its name where the model has a parameter of
    that name (a SinusoidalPosEmb's) and is a layer norm's ``weight``
    everywhere else; without ``expected`` every ``scale`` is a norm's.
    ``params_to_jax`` inverts both."""
    model = StandardModel(DeepIce(scaled_emb=True, **NARROW),
                          [DirectionReconstructionWithKappa(hidden_size=32)],
                          device="cpu")
    tree = params_to_jax(model.state_dict())
    fe = tree["params"]["backbone"]["fourier_ext"]
    assert fe["sin_emb"]["scale"].shape == (1,)
    assert fe["mlp_norm"]["scale"].ndim == 1
    sd = params_from_jax(tree, model.state_dict())
    assert "backbone.fourier_ext.sin_emb.scale" in sd
    assert "backbone.fourier_ext.mlp_norm.weight" in sd
    blind = params_from_jax(tree)
    assert "backbone.fourier_ext.sin_emb.weight" in blind
    assert "backbone.fourier_ext.sin_emb.scale" not in blind
    back = params_to_jax(sd)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, tree))


# ------------------------------------------------------- the zoo configs
ZOO = Path(__file__).resolve().parent.parent / "configs/models/zoo/kaggle_icemix"


def _zoo_arguments(name):
    with open(ZOO / name / "model.yml") as f:
        spec = yaml.safe_load(f)
    return spec["arguments"]["backbone"]["__model__"]["arguments"]


@pytest.mark.parametrize("name", ["B_d32", "B_d32_4rel", "B_d64"])
def test_zoo_config_builds_and_matches_jax(name):
    """Each zoo file whose options the port has builds the port's model
    through ``utils.config.load_model`` at the file's widths, its DeepIce
    on the rel kernels (head dims 32 and 64).  The file cut to two heads
    and one block, built by both packages' registries, gives the port
    model (its rel path the plain streaming versions on the CPU) the
    JAX model's predictions (rtol 2e-4, as the narrow models above)."""
    path = ZOO / name / "model.yml"
    args = _zoo_arguments(name)
    model = load_model(str(path), device="cpu")
    assert isinstance(model.backbone, DeepIce)
    assert model.backbone.hidden_dim == args["hidden_dim"]
    assert model.backbone.depth == args["depth"]
    assert model.backbone.sandwich_0.attn.uses_rel_kernel(args["head_size"])
    del model
    with open(path) as f:
        spec = yaml.safe_load(f)
    backbone = spec["arguments"]["backbone"]["__model__"]["arguments"]
    backbone.update(hidden_dim=2 * args["head_size"], depth=1)
    jbs, tbs = _batches(12, [[40, 3, 17]], length=64)
    jmodel = jax_build(JaxModelConfig.from_dict(copy.deepcopy(spec)))
    params = _random_tree(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jbs[0]), 13)
    j_pred = np.asarray(jmodel.apply(params, jbs[0])[0][0])
    model = build(ModelConfig.from_dict(spec), device="cpu")
    model.load_state_dict(params_from_jax(params, model.state_dict()))
    assert model.backbone.sandwich_0.attn.uses_rel_kernel(args["head_size"])
    with torch.no_grad():
        pred = model(tbs[0])[0][0]
    np.testing.assert_allclose(pred.numpy(), j_pred, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", ["S+DynEdge_d32", "B+DynEdge_d64"])
def test_zoo_config_with_dynedge_is_not_ported(name):
    """(Named when ``include_dynedge`` raised.)  The file's
    ``dynedge_args`` reach ``dyn_edge``: its widths, k, activation, norm
    layers and node-level latents are the file's, the compute dtype
    DeepIce's, and the Fourier features take the other half of the
    width."""
    args = _zoo_arguments(name)
    model = DeepIce(**args)
    dyn, spec = model.dyn_edge, args["dynedge_args"]
    assert dyn.nb_inputs == spec["nb_inputs"] == 8
    assert dyn.nb_neighbours == spec["nb_neighbours"] == 9
    assert dyn.skip_readout and dyn.global_pooling_schemes is None
    assert [getattr(dyn, f"conv_{i}").conv.nn_sizes for i in range(4)] == [
        tuple(s) for s in spec["dynedge_layer_sizes"]]
    assert all(getattr(dyn, f"conv_{i}").conv.activation == "gelu"
               and getattr(dyn, f"conv_{i}").conv.add_norm_layer
               for i in range(4))
    assert dyn.post_processing.sizes == tuple(
        spec["post_processing_layer_sizes"])
    assert dyn.nb_outputs == args["hidden_dim"] // 2
    assert model.fourier_ext.mlp_1.out_features == args["hidden_dim"] // 2
    assert dyn.compute_dtype is None
    bf16 = DeepIce(**{**args, "compute_dtype": "bfloat16"})
    assert bf16.dyn_edge.compute_dtype == "bfloat16"


def _chunked_latents_match_jax(**kw):
    """A narrow DeepIce built with ``kw`` and the JAX DeepIce on the same
    parameters: latents within rtol / atol 2e-5 on a ragged batch with
    an empty event."""
    jbs, tbs = _batches(3, [[70, 0, 9]])
    jmodel = JaxDeepIce(**{**NARROW, **kw})
    params = _random_tree(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jbs[0]), 4)
    model = DeepIce(**{**NARROW, **kw})
    model.load_state_dict(params_from_jax(params["params"],
                                          model.state_dict()))
    with torch.no_grad():
        lat = model(tbs[0]).numpy()
    np.testing.assert_allclose(lat, np.asarray(jmodel.apply(params, jbs[0])),
                               rtol=2e-5, atol=2e-5)


def test_deepice_accepts_rel_bias_cache():
    for cache in ("auto", "always", "never"):
        DeepIce(rel_bias_cache=cache, **NARROW)  # ignored with the kernels
        # the chunked path takes each setting, as the JAX package does
        _chunked_latents_match_jax(rel_flash="never", rel_bias_chunks=4,
                                   rel_bias_cache=cache)


# ----------------------------------------------- Trainer and deployment
def test_trainer_fit_deepice_matches_jax():
    """2 epochs of 2 ragged batches with validation, the default
    schedule, from the same initial parameters (the rel kernel path)."""
    jtrain, ttrain = _batches(5, [[30, 12, 2], [25, 40, 8]], length=64)
    jval, tval = _batches(6, [[20, 0, 33]], length=64)
    jtrainer = JaxTrainer(_jax_model(rel_flash="always"), learning_rate=1e-3)
    jtrainer.init(jtrain[0])
    params0 = jax.device_get(jtrainer.state.params)
    j_hist = jtrainer.fit(jtrain, jval, max_epochs=2)
    trainer = Trainer(_port_model(params0, rel_flash="always"),
                      learning_rate=1e-3)
    hist = trainer.fit(ttrain, tval, max_epochs=2)
    assert trainer.step == 4
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], j_hist[key], rtol=1e-4, err_msg=key)
    exp = params_from_jax(jax.device_get(jtrainer.state.params),
                          trainer.model.state_dict())
    for name, value in trainer.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), exp[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_deployment_module_deepice_matches_jax(tmp_path):
    jmodel = _jax_model()
    jbs, _ = _batches(7, [[5, 9]])
    params = _random_tree(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jbs[0]), 8)
    config, pkl = str(tmp_path / "model.yml"), str(tmp_path / "state_dict.pkl")
    save_model_config(jmodel, config)
    Trainer(_port_model(params)).save_state_dict(pkl)
    jax_module = JaxDeploymentModule(config, pkl)
    module = DeploymentModule(_port_model(None), pkl, device="cpu")
    assert module.prediction_columns == jax_module.prediction_columns
    arrays = _events(np.random.default_rng(9), [12, 0, 30, 1, 3])
    got = module([Event(x=a, features=FEATURES) for a in arrays])
    exp = jax_module([JaxEvent(x=a, features=FEATURES) for a in arrays])
    assert got.shape == (5, 4)
    assert np.isnan(got[1]).all() and np.isfinite(np.delete(got, 1, 0)).all()
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("scaled_emb", [False, True])
def test_params_round_trip_full_width_deepice(scaled_emb):
    """The full-width tree (``eval_shape``: no compile) carried over and
    back: the cls token, the layer scales, the aux table and (scaled)
    the SinusoidalPosEmb scales keep their layout; a missing or unused
    leaf raises."""
    jmodel = JaxStandardModel(
        backbone=JaxDeepIce(scaled_emb=scaled_emb),
        tasks=(JaxDirection(loss_function=jlf.VonMisesFisher3DLoss()),),
    )
    batch = jax_make_batch(_events(np.random.default_rng(10), [5, 9]), length=16)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(11)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = StandardModel(DeepIce(scaled_emb=scaled_emb),
                          [DirectionReconstructionWithKappa(hidden_size=384)],
                          device="cpu")
    sd = params_from_jax(tree, model.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert len(sd) == len(model.state_dict()) == n_leaves == 240 + 2 * scaled_emb
    model.load_state_dict(sd)
    bb = tree["params"]["backbone"]
    np.testing.assert_array_equal(sd["backbone.cls_token"].numpy(), bb["cls_token"])
    assert sd["backbone.cls_token"].shape == (1, 384)
    np.testing.assert_array_equal(sd["backbone.fourier_ext.aux_emb.embedding"].numpy(),
                                  bb["fourier_ext"]["aux_emb"]["embedding"])
    assert sd["backbone.fourier_ext.aux_emb.embedding"].shape == (2, 96)
    np.testing.assert_array_equal(sd["backbone.blocks_11.gamma_2"].numpy(),
                                  bb["blocks_11"]["gamma_2"])
    np.testing.assert_array_equal(sd["backbone.rel_pos.projection.weight"].numpy(),
                                  bb["rel_pos"]["projection"]["kernel"].T)
    np.testing.assert_array_equal(sd["backbone.sandwich_0.norm1.weight"].numpy(),
                                  bb["sandwich_0"]["norm1"]["scale"])
    if scaled_emb:
        np.testing.assert_array_equal(sd["backbone.fourier_ext.sin_emb.scale"].numpy(),
                                      bb["fourier_ext"]["sin_emb"]["scale"])
        assert sd["backbone.fourier_ext.sin_emb2.scale"].shape == (1,)
    back = params_to_jax(model.state_dict())
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, tree))
    missing = jax.tree_util.tree_map(lambda a: a, tree)
    del missing["params"]["backbone"]["blocks_3"]["gamma_1"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, model.state_dict())
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["params"]["backbone"]["blocks_0"]["gamma_3"] = np.ones(384, np.float32)
    with pytest.raises(ValueError, match="unknown kind"):
        params_from_jax(extra, model.state_dict())
