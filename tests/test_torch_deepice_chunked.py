"""The port's DeepIce on its chunked relative-bias paths against the JAX
DeepIce on the CPU: ``rel_bias_chunks`` 1, 3 and 4 (3 leaves a short
last tile) on each ``rel_bias_cache`` setting, at a head dim the rel
kernels do not take (8) and at 32 with ``rel_flash="never"``; latents,
the loss and every gradient of a ``VonMisesFisher3DLoss`` step from the
same parameters (``params_from_jax``), bfloat16, and the "auto" rule on
both sides of its limit."""

import numpy as np
import pytest
import torch

import jax

from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.models.gnn.icemix import DeepIce as JaxDeepIce
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    DirectionReconstructionWithKappa as JaxDirection,
)
from graphnet_tpu.training import loss_functions as jlf
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.models.components import layers
from graphnet_tpu_torch.models.components.embedding import SpacetimeEncoder
from graphnet_tpu_torch.models.gnn import icemix
from graphnet_tpu_torch.models.gnn.icemix import DeepIce
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import (
    DirectionReconstructionWithKappa,
)
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(2)

# tests/test_backbones_advanced.py's chunked shape (head 8: no rel
# kernel, both rel blocks biased), and head 32 with the kernels off
SHAPES = {
    "hd8": dict(hidden_dim=32, seq_length=32, depth=1, depth_rel=2, n_rel=2,
                head_size=8, n_features=4),
    "hd32": dict(hidden_dim=64, seq_length=32, depth=1, depth_rel=2, n_rel=1,
                 head_size=32, n_features=6, rel_flash="never"),
}
LENGTHS = [30, 0, 7, 19]
L = 32


def _events(rng, n_features):
    """Kaggle-like pulses: positions ~N(0, 0.5^2), times in [0, 0.03),
    charge, a 0/1 auxiliary flag."""
    out = []
    for n in LENGTHS:
        cols = [rng.standard_normal((n, 3)) * 0.5, rng.random((n, 1)) * 0.03,
                rng.random((n, 1)), rng.random((n, 1)) > 0.5]
        out.append(np.concatenate(cols, axis=1)[:, :n_features]
                   .astype(np.float32))
    return out


def _batches(n_features, seed=0):
    rng = np.random.default_rng(seed)
    events = _events(rng, n_features)
    d = rng.standard_normal((len(LENGTHS), 3))
    labels = {"direction": (d / np.linalg.norm(d, axis=1, keepdims=True))
              .astype(np.float32)}
    return (jax_make_batch(events, labels=labels, length=L),
            make_batch(events, labels=labels, length=L))


def _random_tree(shapes, seed):
    """Dense kernels N(0, 1/fan_in), every other leaf N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.5
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


@pytest.fixture(scope="module")
def params():
    """Each shape's parameters, drawn once from the unchunked JAX
    model's tree (a chunked model has the same tree)."""
    out = {}
    for name, kw in SHAPES.items():
        jb, _ = _batches(kw["n_features"])
        jmodel = _jax_model(kw)
        out[name] = _random_tree(
            jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jb), 1)
    return out


def _jax_model(kw, **extra):
    return JaxStandardModel(
        backbone=JaxDeepIce(**{**kw, **extra}),
        tasks=(JaxDirection(loss_function=jlf.VonMisesFisher3DLoss()),),
    )


def _port_model(kw, tree, **extra):
    model = StandardModel(
        DeepIce(**{**kw, **extra}),
        [DirectionReconstructionWithKappa(
            hidden_size=kw["hidden_dim"],
            loss_function=tlf.VonMisesFisher3DLoss())],
        device="cpu",
    )
    model.load_state_dict(params_from_jax(tree, model.state_dict()))
    return model


def test_chunked_tree_is_the_unchunked_one(params):
    """The chunked model adds no parameter: its JAX tree is the unchunked
    one's, and ``params_from_jax`` fills the port's chunked model from
    it."""
    kw = SHAPES["hd8"]
    jb, _ = _batches(kw["n_features"])
    chunked = jax.eval_shape(_jax_model(kw, rel_bias_chunks=4).init,
                             jax.random.PRNGKey(0), jb)
    assert (jax.tree_util.tree_structure(chunked)
            == jax.tree_util.tree_structure(params["hd8"]))
    model = _port_model(kw, params["hd8"], rel_bias_chunks=4)
    assert set(model.state_dict()) == set(_port_model(
        kw, params["hd8"]).state_dict())


_JAX_RUNS = {}


def _jax_run(kw, tree, **extra):
    """The JAX model's latents, predictions, loss and gradients."""
    jb, _ = _batches(kw["n_features"])
    jmodel = _jax_model(kw, **extra)

    def loss_fn(p):
        outs = jmodel.apply(p, jb)
        return jmodel.loss_from_batch(outs, jb), outs[0][0]

    (j_loss, j_pred), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(tree)
    j_lat = np.asarray(jax.jit(jmodel.backbone.apply)(
        {"params": tree["params"]["backbone"]}, jb))
    return j_lat, j_pred, j_loss, j_grads


@pytest.mark.parametrize("cache", ["always", "never", "auto"])
@pytest.mark.parametrize("chunks", [1, 3, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_chunked_deepice_matches_jax(params, shape, chunks, cache):
    """Latents and predictions within rtol / atol 2e-5, the loss within
    rtol 2e-5 and every gradient within 1e-4 of its own max, from the
    same parameters on a batch with an empty event."""
    kw = SHAPES[shape]
    tree = params[shape]
    extra = dict(rel_bias_chunks=chunks, rel_bias_cache=cache)
    _, tb = _batches(kw["n_features"])
    # the JAX model caches at these sizes under "auto" and ignores the
    # setting with one chunk: one JAX run serves the equal programs
    key = (shape, chunks, "never" if chunks > 1 and cache == "never"
           else "always")
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_run(kw, tree, rel_bias_chunks=chunks,
                                  rel_bias_cache=key[2])
    j_lat, j_pred, j_loss, j_grads = _JAX_RUNS[key]
    model = _port_model(kw, tree, **extra)
    backbone = model.backbone
    assert not backbone.sandwich_0.attn.uses_rel_kernel(kw["head_size"])
    lat = backbone(tb)
    outs = model(tb)
    loss = model.loss_from_batch(outs, tb)
    loss.backward()
    np.testing.assert_allclose(lat.detach().numpy(), j_lat, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(outs[0][0].detach().numpy(), np.asarray(j_pred),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=2e-5)
    exp = params_from_jax(jax.device_get(j_grads), model.state_dict())
    for name, p in model.named_parameters():
        e = exp[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), e, rtol=0,
                                   atol=1e-4 * np.abs(e).max(), err_msg=name)


def test_chunked_routes(params, monkeypatch):
    """Which route a biased block takes: with ``rel_bias_chunks`` 3 the
    cached route calls the encoder once a forward on every pair, the
    rebuilt route once a tile on that tile's rows (again in the
    backward, where a cached tile reads its slice again); with 1 the
    encoder runs once, whatever the cache says."""
    kw = SHAPES["hd8"]
    _, tb = _batches(kw["n_features"])
    calls = []
    forward = icemix.SpacetimeEncoder.forward

    def counted(self, x, x_query=None):
        calls.append(x.shape[1] if x_query is None else x_query.shape[1])
        return forward(self, x, x_query)

    monkeypatch.setattr(icemix.SpacetimeEncoder, "forward", counted)
    for chunks, cache, expect in ((3, "always", [L]),
                                  (3, "never", [11, 11, 10] * 2),
                                  (1, "never", [L])):
        calls.clear()
        model = _port_model(kw, params["hd8"], rel_bias_chunks=chunks,
                            rel_bias_cache=cache)
        with torch.no_grad():
            model.backbone(tb)
        assert calls == expect, (chunks, cache, calls)
    # under autograd each rebuilt tile runs again in the backward
    calls.clear()
    model = _port_model(kw, params["hd8"], rel_bias_chunks=3,
                        rel_bias_cache="never")
    model.backbone(tb).sum().backward()
    assert calls == [11, 11, 10] * 2 + [10, 11, 11] * 2  # backward: reversed
    # a cached tile runs again from its slice of the cache: one encoding
    calls.clear()
    model = _port_model(kw, params["hd8"], rel_bias_chunks=3,
                        rel_bias_cache="always")
    model.backbone(tb).sum().backward()
    assert calls == [L]


def test_auto_limit():
    """"auto" caches a pair tensor of at most ``REL_CACHE_AUTO_BYTES``:
    4 bytes a value in fp32, 2 in bfloat16, on both sides of the limit."""
    limit = icemix.REL_CACHE_AUTO_BYTES
    kw = dict(SHAPES["hd32"], rel_bias_chunks=4)
    fp32, bf16 = DeepIce(**kw), DeepIce(**kw, compute_dtype="bfloat16")
    hd = kw["head_size"]

    def largest(size):  # the largest B*L*L that fits, at B = 1
        return int((limit / (hd * size)) ** 0.5)

    for model, size in ((fp32, 4), (bf16, 2)):
        n = largest(size)
        assert n * n * hd * size <= limit < (n + 1) ** 2 * hd * size
        assert model.caches_rel_bias(1, n)
        assert not model.caches_rel_bias(1, n + 1)
    # bfloat16 halves the bytes: a length fp32 rebuilds, bf16 caches
    assert not fp32.caches_rel_bias(1, largest(4) + 1)
    assert bf16.caches_rel_bias(1, largest(4) + 1)
    assert DeepIce(**kw, rel_bias_cache="always").caches_rel_bias(64, 10 ** 4)
    assert not DeepIce(**kw, rel_bias_cache="never").caches_rel_bias(1, 1)
    # the JAX rule at the test shapes caches, as the port's does
    assert 4 * L * L * hd * 4 <= 700e6 and fp32.caches_rel_bias(4, L)


def test_bf16_chunked_matches_jax():
    """tests/test_bf16.py's chunked DeepIce (head 16, ``rel_bias_chunks``
    4; the port with ``rel_flash="never"``, as the JAX package runs it on
    the CPU) in bfloat16 against the JAX one in bfloat16 and against
    fp32, by that test's measure: the mean difference under 5 % of the
    fp32 latents' mean magnitude."""
    kw = dict(hidden_dim=64, seq_length=32, depth=1, depth_rel=2, n_rel=1,
              head_size=16, n_features=4, rel_bias_chunks=4)
    rng = np.random.default_rng(0)
    events = [rng.standard_normal((int(rng.integers(8, 30)), 4))
              .astype(np.float32) for _ in range(3)]
    jb, tb = jax_make_batch(events, length=32), make_batch(events, length=32)
    tree = _random_tree(jax.eval_shape(JaxDeepIce(**kw).init,
                                       jax.random.PRNGKey(0), jb), 5)
    j32 = np.asarray(jax.jit(JaxDeepIce(**kw).apply)(tree, jb))
    j16 = np.asarray(jax.jit(JaxDeepIce(**kw, compute_dtype="bfloat16").apply)(
        tree, jb))
    out = {}
    for dtype in (None, "bfloat16"):
        model = DeepIce(**kw, rel_flash="never", compute_dtype=dtype)
        model.load_state_dict(params_from_jax(tree["params"],
                                              model.state_dict()))
        assert model.caches_rel_bias(3, 32)
        with torch.no_grad():
            out[dtype] = model(tb).numpy()
    assert out["bfloat16"].dtype == np.float32
    assert np.isfinite(out["bfloat16"]).all()
    np.testing.assert_allclose(out[None], j32, rtol=2e-5, atol=2e-5)
    scale = np.abs(j32).mean() + 1e-3
    assert np.abs(out["bfloat16"] - j16).mean() / scale < 0.05
    assert np.abs(out["bfloat16"] - out[None]).mean() / scale < 0.05


def test_chunked_rel_attention_equals_dense():
    """``AttentionRel._chunked_rel`` on a cached tensor and on rebuilt
    tiles equals the dense path on the whole tensor, tile by tile, for
    every chunk count up to past L (a tile a row)."""
    torch.manual_seed(0)
    B, H, Lq, hd = 2, 3, 7, 8
    enc = SpacetimeEncoder(hd)
    x0 = torch.randn(B, Lq, 4) * 0.5
    q, k, v = (torch.randn(B, H, Lq, hd) for _ in range(3))
    mask = torch.ones(B, Lq, dtype=torch.bool)
    mask[1, 4:] = False
    with torch.no_grad():
        rel = enc(x0)
        dense = layers._dense_rel_attention(q, k, v, mask, rel)
        for chunks in (2, 3, 7, 9):
            attn = layers.AttentionRel(H * hd, H, rel_chunks=chunks,
                                       rel_flash="never")
            for got in (attn._chunked_rel(q, k, v, mask, rel_cached=rel),
                        attn._chunked_rel(q, k, v, mask,
                                          rel_source=(enc, x0))):
                torch.testing.assert_close(got, dense, rtol=1e-6, atol=1e-6)
