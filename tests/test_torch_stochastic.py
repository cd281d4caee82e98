"""The port's stochastic layers against the JAX package on the CPU, fed
the same keep masks: the port's masks are recorded through its one mask
function (``stochastic.keep_mask``) and replayed into the JAX package by
wrapping ``jax.random.bernoulli`` here.  Every dropout site of the
layers, each backbone with ``deterministic=False``, ``Trainer.fit`` with
dropout, the deterministic switch, the generator's masks, and
DeepIce's ``remat`` (with DropPath on)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.models.components import layers as jlayers
from graphnet_tpu.models.gnn.convnet import ConvNet as JaxConvNet
from graphnet_tpu.models.gnn.dynedge_kaggle_tito import DynEdgeTITO as JaxTITO
from graphnet_tpu.models.gnn.particlenet import ParticleNeT as JaxParticleNeT
from graphnet_tpu.models.gnn.rnn_tito import RNNTITO as JaxRNNTITO
from graphnet_tpu.models.rnn.node_rnn import NodeRNN as JaxNodeRNN
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    DirectionReconstructionWithKappa as JaxDirection,
    EnergyReconstruction as JaxEnergy,
)
from graphnet_tpu.training import loss_functions as jlf
from graphnet_tpu.training.trainer import Trainer as JaxTrainer
from graphnet_tpu.utils import config as jconfig
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.models.components import layers as tlayers
from graphnet_tpu_torch.models.components import stochastic
from graphnet_tpu_torch.models.graphs.nodes import NodeAsDOMTimeSeries
from graphnet_tpu_torch.models.gnn.icemix import DeepIce
from graphnet_tpu_torch.models.gnn.particlenet import ParticleNeTConv
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import (
    DirectionReconstructionWithKappa,
)
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils import config
from graphnet_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(2)

RATE = 0.3


# ------------------------------------------------------------ the masks
def record_port_masks(monkeypatch):
    """Wrap the port's mask function: every mask it draws is kept, in
    order, as ``(numpy mask, keep probability)``."""
    tape, real = [], stochastic.keep_mask

    def recording(shape, keep_prob, device):
        mask = real(shape, keep_prob, device)
        tape.append((mask.cpu().numpy(), keep_prob))
        return mask

    monkeypatch.setattr(stochastic, "keep_mask", recording)
    return tape


def replay_into_jax(monkeypatch, tape):
    """Wrap ``jax.random.bernoulli``: each draw returns the next recorded
    mask (same shape and probability); past the tape, the real draw (a
    layer whose output the port does not compute).  Returns the shapes
    drawn past the tape."""
    queue, real, extra = list(tape), jax.random.bernoulli, []

    def replaying(key, p=0.5, shape=None, mode="low"):
        if not queue:
            extra.append(tuple(shape))
            return real(key, p, shape)
        mask, keep = queue.pop(0)
        assert tuple(shape) == mask.shape, (shape, mask.shape)
        np.testing.assert_allclose(float(p), keep, rtol=1e-7)
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", replaying)
    return extra


def _random_tree(tree, seed):
    rng = np.random.default_rng(seed)

    def draw(a):
        shape = np.shape(a)
        scale = 1 / np.sqrt(shape[0]) if len(shape) == 2 else 0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, tree)


def _biases_before_batch_norm(module):
    """Names of the biases a batch norm in training takes straight
    (ParticleNeT's EdgeConv denses): the norm subtracts the batch mean,
    so their true gradient is 0 and both packages read rounding."""
    names = set()
    for prefix, m in module.named_modules():
        if isinstance(m, ParticleNeTConv) and m.add_batchnorm:
            for i in range(len(m.nn_sizes)):
                if not getattr(m, f"bn_{i}").frozen:
                    dense = "self_dense" if i == 0 else f"dense_{i}"
                    names.add(f"{prefix}.{dense}.bias" if prefix
                              else f"{dense}.bias")
    return names


# the most a true-zero gradient may read, as a share of the model's
# largest (float32 rounding of its sum)
ROUNDING = 1e-5


def _assert_grads(module, jgrads, rtol=2e-4):
    """The port module's parameter gradients against the JAX tree's,
    each within ``rtol`` of its own max.  Where that max is 0 (two of
    RNN_TITO's GRU hidden weights on these events), or the parameter is
    a bias before a batch norm (whose JAX gradient must then be
    rounding), within ``rtol`` of 1e-3 of the model's largest."""
    exp = params_from_jax(jax.device_get(jgrads), module.state_dict())
    top = max(float(exp[n].abs().max()) for n, _ in module.named_parameters())
    rounding = _biases_before_batch_norm(module)
    for name, p in module.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        ref = exp[name].numpy()
        scale = float(np.abs(ref).max())
        if name in rounding:
            assert scale <= ROUNDING * top, (name, scale / top)
        if name in rounding or scale == 0.0:
            scale = 1e-3 * top
        np.testing.assert_allclose(g, ref, rtol=rtol, atol=rtol * scale,
                                   err_msg=name)


# ------------------------------------------------- each site of layers
def _x_mask(B=2, L=24, D=32, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    lengths = np.array([17, L, 9, L, 1, 20])[:B]
    mask = np.arange(L)[None, :] < lengths[:, None]
    return x, mask


def _dyntrans_args():
    x, mask = _x_mask(D=32)
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 24, (2, 24, 6)).astype(np.int32)
    em = (rng.random((2, 24, 6)) > 0.2) & mask[..., None]
    return x, mask, idx, em


# site: (JAX module, port module, inputs, masks drawn)
SITES = {
    "mha_attention": lambda: (
        jlayers.MultiHeadAttention(num_heads=2, dropout_rate=RATE,
                                   deterministic=False),
        tlayers.MultiHeadAttention(32, 2, dropout_rate=RATE,
                                   deterministic=False),
        _x_mask(), 1),
    "encoder_layer": lambda: (
        jlayers.TransformerEncoderLayer(num_heads=2, dim_feedforward=48,
                                        dropout_rate=RATE,
                                        deterministic=False),
        tlayers.TransformerEncoderLayer(32, 2, dim_feedforward=48,
                                        dropout_rate=RATE,
                                        deterministic=False),
        _x_mask(), 4),
    "dyntrans": lambda: (
        jlayers.DynTrans(layer_sizes=(32, 32, 32), n_head=2,
                         dropout_rate=RATE, deterministic=False),
        tlayers.DynTrans(layer_sizes=(32, 32, 32), n_head=2,
                         dropout_rate=RATE, deterministic=False),
        _dyntrans_args(), 4),
    "mlp": lambda: (
        jlayers.Mlp(hidden_features=48, dropout=RATE, deterministic=False),
        tlayers.Mlp(32, 48, dropout=RATE, deterministic=False),
        _x_mask()[:1], 2),
    "drop_path": lambda: (
        jlayers.DropPath(RATE, deterministic=False),
        tlayers.DropPath(RATE, deterministic=False),
        (_x_mask(B=6)[0],), 1),
    "block": lambda: (
        jlayers.Block(num_heads=2, drop_path=RATE, init_values=0.7,
                      deterministic=False),
        tlayers.Block(32, 2, drop_path=RATE, init_values=0.7,
                      deterministic=False),
        _x_mask(B=6), 2),
    "block_rel": lambda: (
        jlayers.BlockRel(num_heads=2, drop_path=RATE, deterministic=False),
        tlayers.BlockRel(32, 2, drop_path=RATE, deterministic=False),
        _x_mask(B=6), 2),
}


def _call(module, args, torch_side):
    if isinstance(module, (jlayers.Block, jlayers.BlockRel, tlayers.Block,
                           tlayers.BlockRel)):
        return module(args[0], key_padding_mask=args[1])
    return module(*args)


@pytest.mark.parametrize("site", list(SITES))
def test_dropout_site_matches_jax(site, monkeypatch):
    """Each stochastic site on, fed the port's masks: the output and
    every parameter's and the input's gradient within rtol 2e-4."""
    jmod, tmod, args, n_masks = SITES[site]()
    jargs = [jnp.asarray(a) for a in args]
    variables = _call_jax(jmod, None, jargs[0], jargs, site)
    params = _random_tree(jax.device_get(variables), 3)
    if params:
        tmod.load_state_dict(params_from_jax(params, tmod.state_dict()))
    tmod.train()
    targs = [torch.from_numpy(a) for a in args]
    targs[0].requires_grad_()
    tape = record_port_masks(monkeypatch)
    with stochastic.use_generator(torch.Generator().manual_seed(5)):
        out = _call(tmod, targs, True)
    assert len(tape) == n_masks
    assert any(not m.all() for m, _ in tape)  # the masks drop something
    g = np.random.default_rng(9).standard_normal(out.shape).astype(np.float32)
    (out * torch.from_numpy(g)).sum().backward()

    extra = replay_into_jax(monkeypatch, tape)

    def apply(p, x):
        return _call_jax(jmod, p, x, jargs, site)

    exp, vjp = jax.vjp(apply, params, jargs[0])
    jgrads, jgx = vjp(jnp.asarray(g))
    assert not extra
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(exp),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(targs[0].grad.numpy(), np.asarray(jgx),
                               rtol=2e-4, atol=2e-4 * float(np.abs(jgx).max()))
    if params:
        _assert_grads(tmod, jgrads)


def _call_jax(jmod, params, x, jargs, site):
    """``jmod.apply(params, x, ...)``, or ``jmod.init`` without params."""
    if site.startswith("block"):
        args, kw = (x,), {"key_padding_mask": jargs[1]}
    else:
        args, kw = (x, *jargs[1:]), {}
    if params is None:
        return jmod.init({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(1)}, *args, **kw)
    return jmod.apply(params, *args, rngs={"dropout": jax.random.PRNGKey(2)},
                      **kw)


@pytest.mark.parametrize("site", list(SITES))
def test_deterministic_rates_change_nothing(site):
    """With ``deterministic=True``, or in eval mode, the rates change
    nothing: the same bits as the layer without them, no draw and no
    generator needed."""
    _, tmod, args, _ = SITES[site]()
    tlayers.init_parameters(tmod, torch.Generator().manual_seed(0))
    targs = [torch.from_numpy(a) for a in args]
    for module in tmod.modules():
        if hasattr(module, "deterministic"):
            module.deterministic = True
    tmod.train()
    on_det = _call(tmod, targs, True)
    for module in tmod.modules():
        if hasattr(module, "deterministic"):
            module.deterministic = False
    tmod.eval()
    on_eval = _call(tmod, targs, True)
    for module in tmod.modules():
        if isinstance(module, stochastic.Dropout):
            module.rate = 0.0
        if isinstance(module, tlayers.DropPath):
            module.drop_prob = 0.0
    tmod.train()
    off = _call(tmod, targs, True)
    assert torch.equal(on_det, off) and torch.equal(on_eval, off)


def test_a_layer_on_without_a_generator_raises():
    layer = stochastic.Dropout(0.5, deterministic=False)
    with pytest.raises(RuntimeError, match="generator"):
        layer(torch.ones(4))
    assert torch.equal(layer.eval()(torch.ones(4)), torch.ones(4))


# --------------------------------------------------------- the backbones
L = 32
RNN_NARROW = dict(nb_inputs=6, time_series_columns=(4, 3), rnn_hidden_size=12,
                  dyntrans_layer_sizes=((32, 32),),
                  post_processing_layer_sizes=(40, 32),
                  readout_layer_sizes=(32, 16), n_head=2)
BACKBONES = {
    "tito": lambda: JaxTITO(
        nb_inputs=4, dyntrans_layer_sizes=((32, 32), (32, 32)), n_head=2,
        post_processing_layer_sizes=(40, 32), readout_layer_sizes=(32, 16),
        dropout_rate=0.1, deterministic=False),
    "convnet": lambda: JaxConvNet(nb_inputs=4, nb_outputs_=6,
                                  nb_intermediate=8, deterministic=False),
    "particlenet": lambda: JaxParticleNeT(
        nb_inputs=4, nb_neighbours=8, dynedge_layer_sizes=((8, 8), (16, 16)),
        readout_layer_sizes=(12, 10), deterministic=False),
    # GraphNeT's RNN_TITO reads the first GRU layer: its dropout between
    # layers changes nothing, and the port draws no mask for it
    "rnn_tito": lambda: JaxRNNTITO(rnn_layers=2, rnn_dropout=0.5,
                                   deterministic=False, **RNN_NARROW),
    # the last layer's state: the dropout between the layers counts
    "node_rnn_last_layer": lambda: JaxNodeRNN(
        nb_inputs=2, hidden_size=12, num_layers=2, time_series_columns=(4, 3),
        dropout=0.5, deterministic=False, final_state_layer=1),
}
LENGTHS = (23, 0, 1, 17, 9)
# draws of each backbone's step: TITO 4 a block, ConvNet 5, ParticleNeT
# 2, RNN_TITO none (the JAX package draws its unused one), NodeRNN 1
DRAWS = {"tito": (8, 0), "convnet": (5, 0), "particlenet": (2, 0),
         "rnn_tito": (0, 1), "node_rnn_last_layer": (1, 0)}


def _dom_events(rng, lengths):
    nodes = NodeAsDOMTimeSeries(keys=["x", "y", "z", "t"],
                                id_columns=["x", "y", "z"], time_column="t",
                                charge_column="no_charge")
    events = []
    for n in lengths:
        sensors = rng.standard_normal((max(n // 3, 1), 3)) * 50
        events.append(nodes(np.concatenate(
            [sensors[rng.integers(0, len(sensors), n)],
             rng.random((n, 1)) * 1e3], axis=1)))
    return events


def _backbone_batches(kind, seed):
    rng = np.random.default_rng(seed)
    if kind in ("rnn_tito", "node_rnn_last_layer"):
        events = _dom_events(rng, LENGTHS)
    else:
        events = [(rng.standard_normal((n, 4)) * [50, 50, 50, 5]).astype(
            np.float32) for n in LENGTHS]
    if kind == "tito":
        labels = {"direction": _directions(rng, len(events))}
    else:
        labels = {"total_energy": np.abs(rng.standard_normal(len(events))
                                         * 100 + 200).astype(np.float32)}
    return (jax_make_batch(events, labels=labels, length=L),
            make_batch(events, labels=labels, length=L))


def _directions(rng, n):
    v = rng.standard_normal((n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _jax_model(kind):
    backbone = BACKBONES[kind]()
    if kind == "tito":
        task = JaxDirection(loss_function=jlf.VonMisesFisher3DLoss())
    else:
        task = JaxEnergy(loss_function=jlf.LogCoshLoss(),
                         target_labels=("total_energy",))
    return JaxStandardModel(backbone=backbone, tasks=(task,))


def _port_model(jmodel):
    return config.build(config.ModelConfig.from_dict(
        jconfig.capture_config(jmodel).as_dict()), seed=0, device="cpu")


@pytest.mark.parametrize("kind", list(BACKBONES))
def test_backbone_step_with_dropout_matches_jax(kind, monkeypatch):
    """A training step of each backbone with ``deterministic=False``, fed
    the port's masks: the loss and every gradient within rtol 2e-4."""
    jb, tb = _backbone_batches(kind, 0)
    n_port, n_extra = DRAWS[kind]
    if kind == "node_rnn_last_layer":
        jmod = BACKBONES[kind]()
        variables = jmod.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(1)}, jb)
        params = _random_tree(jax.device_get(variables), 2)
        tmod = config.build(config.ModelConfig.from_dict(
            jconfig.capture_config(jmod).as_dict()))
        tmod.load_state_dict(params_from_jax(params, tmod.state_dict()))
        # the sensor nodes: 5 summary columns and the GRU's 12
        w = np.random.default_rng(4).standard_normal(5 + 12).astype(
            np.float32)

        def jloss(p):
            out = jmod.apply(p, jb, rngs={"dropout": jax.random.PRNGKey(3)})
            return jnp.sum(jnp.where(out.mask[..., None], out.x, 0.0) * w)

        def tloss(m):
            out = m(tb)
            return (torch.where(out.mask[..., None], out.x, 0.0)
                    * torch.from_numpy(w)).sum()
    else:
        jmod = _jax_model(kind)
        variables = jmod.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(1)}, jb)
        params = _random_tree(jax.device_get(variables), 2)
        tmod = _port_model(jmod)
        tmod.load_state_dict(params_from_jax(params, tmod.state_dict()))

        def jloss(p):
            out = jmod.apply(p, jb, rngs={"dropout": jax.random.PRNGKey(3)})
            return jmod.loss_from_batch(out, jb)

        def tloss(m):
            return m.loss_from_batch(m(tb), tb)

    tape = record_port_masks(monkeypatch)
    tmod.train()
    with stochastic.use_generator(torch.Generator().manual_seed(11)):
        loss = tloss(tmod)
    loss.backward()
    assert len(tape) == n_port
    extra = replay_into_jax(monkeypatch, tape)
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    assert len(extra) == n_extra
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-4)
    _assert_grads(tmod, jgrads)


# ------------------------------------------------------ Trainer.fit
def test_trainer_fit_with_dropout_matches_jax(monkeypatch):
    """Two epochs of one batch of a one-block TITO with dropout 0.1 on
    (the JAX step traced anew each step, so each draws): the port's masks
    replayed into the JAX
    Trainer; the losses and the parameters within 1e-4."""
    jbs, tbs = _backbone_batches("tito", 1)
    jmodel = JaxStandardModel(
        backbone=JaxTITO(nb_inputs=4, dyntrans_layer_sizes=((32, 32),),
                         n_head=2, post_processing_layer_sizes=(40, 32),
                         readout_layer_sizes=(32, 16), dropout_rate=0.1,
                         deterministic=False),
        tasks=(JaxDirection(loss_function=jlf.VonMisesFisher3DLoss()),))
    jtrainer = JaxTrainer(jmodel, learning_rate=1e-2)
    jtrainer.init(jbs)
    params0 = _random_tree(jax.device_get(jtrainer.state.params), 6)
    model = _port_model(jmodel)
    model.load_state_dict(params_from_jax(params0, model.state_dict()))
    tape = record_port_masks(monkeypatch)
    hist = Trainer(model, learning_rate=1e-2).fit([tbs], max_epochs=2)
    assert len(tape) == 2 * 4
    jtrainer.init(jbs)
    jtrainer.state.params = params0
    jtrainer.state.opt_state = jtrainer.optimizer.init(params0)
    extra = replay_into_jax(monkeypatch, tape)
    step = jtrainer._single_train_step

    def traced_anew(batch):  # a jitted step keeps the masks of its trace
        jtrainer._make_steps()
        return step(batch)

    monkeypatch.setattr(jtrainer, "_single_train_step", traced_anew)
    j_hist = jtrainer.fit([jbs], max_epochs=2)
    assert not extra
    np.testing.assert_allclose(hist["train_loss"], j_hist["train_loss"],
                               rtol=1e-4)
    exp = params_from_jax(jax.device_get(jtrainer.state.params),
                          model.state_dict())
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), exp[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * float(exp[name].abs().max()),
                                   err_msg=name)


# ---------------------------------------------------- the generator
def test_generator_masks_are_reproducible_and_binomial():
    """Masks from the Trainer's generator: the same seed and step the
    same masks, another step others; the kept share of a million draws
    within five binomial sigmas of ``1 - rate``."""
    model = StandardModel(
        DeepIce(hidden_dim=32, head_size=16, seq_length=16, depth=1,
                depth_rel=1),
        [DirectionReconstructionWithKappa(hidden_size=32)], device="cpu")

    def masks(seed, step, rate=0.3):
        trainer = Trainer(model, seed=seed)
        trainer.step = step
        with stochastic.use_generator(trainer.step_generator()):
            return stochastic.keep_mask((1000, 1000), 1 - rate,
                                        torch.device("cpu"))

    a, b = masks(1, 7), masks(1, 7)
    assert torch.equal(a, b)
    assert not torch.equal(a, masks(1, 8))
    assert not torch.equal(a, masks(2, 7))
    for rate in (0.1, 0.5):
        kept = float(masks(3, 0, rate).float().mean())
        sigma = np.sqrt(rate * (1 - rate) / 1e6)
        assert abs(kept - (1 - rate)) < 5 * sigma, (rate, kept)


@pytest.mark.parametrize("drop_path", [0.0, 0.4], ids=["off", "on"])
def test_the_step_generator_is_seeded_at_the_first_draw(drop_path,
                                                        monkeypatch):
    """``Trainer.train_step`` seeds its generator at the step's first
    draw: a model with no stochastic layer on never builds or seeds one;
    with DropPath on, every step seeds it once, from ``(seed + 1,
    step)``."""
    rng = np.random.default_rng(1)
    events = [rng.standard_normal((n, 4)).astype(np.float32)
              for n in (9, 3)]
    batch = make_batch(events, labels={"direction": _directions(rng, 2)},
                       length=12)
    seeded, real = [], stochastic.step_seed

    def counting(seed, step):
        seeded.append((seed, step))
        return real(seed, step)

    monkeypatch.setattr(stochastic, "step_seed", counting)
    trainer = Trainer(_ice_model(False, drop_path), seed=4)
    for _ in range(2):
        trainer.train_step(batch)
    if drop_path:
        assert seeded == [(5, 0), (5, 1)]
    else:
        assert seeded == [] and trainer._generator is None


# ----------------------------------------------------------------- remat
def _ice_model(remat, drop_path):
    model = StandardModel(
        DeepIce(hidden_dim=32, head_size=16, seq_length=16, depth=2,
                depth_rel=2, n_features=4, remat=remat),
        [DirectionReconstructionWithKappa(
            hidden_size=32, loss_function=tlf.VonMisesFisher3DLoss())],
        device="cpu", seed=3)
    if drop_path:
        for block in ("sandwich_0", "sandwich_1", "blocks_0", "blocks_1"):
            for dp in ("dp1", "dp2"):
                layer = getattr(getattr(model.backbone, block), dp)
                layer.drop_prob, layer.deterministic = drop_path, False
    return model


@pytest.mark.parametrize("drop_path", [0.0, 0.4], ids=["no_drop_path",
                                                       "drop_path"])
def test_remat_leaves_the_gradients(drop_path, monkeypatch):
    """``DeepIce(remat=True)``: the same loss and gradients as without,
    bit for bit, with DropPath on too (every block's masks drawn before
    its checkpointed call, so the recompute applies the forward's);
    the blocks really are recomputed."""
    rng = np.random.default_rng(0)
    events = [rng.standard_normal((n, 4)).astype(np.float32)
              for n in (20, 7, 1, 16)]
    batch = make_batch(events, labels={"direction": _directions(rng, 4)},
                       length=24)
    calls = []
    real = tlayers.Block.forward

    def counting(self, *args, **kw):
        calls.append(torch.is_grad_enabled())
        return real(self, *args, **kw)

    monkeypatch.setattr(tlayers.Block, "forward", counting)
    grads = {}
    for remat in (False, True):
        model = _ice_model(remat, drop_path)
        trainer = Trainer(model, seed=4)
        trainer.init()
        trainer.model.train()
        with stochastic.use_generator(trainer.step_generator()):
            loss = model.loss_from_batch(model(batch), batch)
            loss.backward()
        grads[remat] = (float(loss), {n: p.grad.clone()
                                      for n, p in model.named_parameters()})
        n_calls, calls[:] = len(calls), []
        assert n_calls == (4 if remat else 2), (remat, n_calls)
    assert grads[False][0] == grads[True][0]
    for name, g in grads[False][1].items():
        assert torch.equal(g, grads[True][1][name]), name
