"""The port's flash attention (plain forward and backward, through the
autograd Function that the card runs with its kernels) and its
attention layers against the JAX package on the CPU.  The JAX flash
kernel runs in Pallas interpret mode, as in ``test_flash_attention.py``."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import graphnet_tpu.ops.flash_attention as fa
from graphnet_tpu.models.components.layers import DynTrans as JaxDynTrans
from graphnet_tpu.models.components.layers import (
    MultiHeadAttention as JaxMHA,
    TransformerEncoderLayer as JaxEncoder,
)
from graphnet_tpu_torch.models.components.layers import (
    DynTrans,
    MultiHeadAttention,
    TransformerEncoderLayer,
)
from graphnet_tpu_torch.ops import flash_attention_cuda as tfa
from graphnet_tpu_torch.utils.jax_params import params_from_jax

# The first multi-threaded torch.exp of a process can be wrong: in
# PyTorch's CPU builds with MKL, ATen's exp calls MKL's VML chunk by
# chunk from the OpenMP threads, and when two threads make the
# process's first VML call at once (under load) the second chunk came
# out 1.5e-4 off (relative) instead of 6e-8.  One VML call in a single
# thread first (a tensor too small to split) initialises it; at import,
# so before any test of the worker process runs.
torch.exp(torch.zeros(16))
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Run the JAX flash kernels in interpreter mode."""
    import jax.experimental.pallas as pl

    monkeypatch.setattr(
        fa.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _qkvg(B=2, H=2, L=128, D=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4)]


MASKS = {
    "no_padding": lambda L: np.ones((2, L), bool),
    "padding": lambda L: np.arange(L)[None, :] < np.array([[L * 3 // 4], [L // 2]]),
    # event 1 has no valid key (a padding event); event 0 one valid key
    "fully_masked": lambda L: np.stack([np.arange(L) < 1, np.zeros(L, bool)]),
}


def _jax_flash(q, k, v, mask, g):
    def loss(q, k, v):
        return jnp.sum(fa.flash_attention(q, k, v, jnp.asarray(mask)) * g)

    args = [jnp.asarray(a) for a in (q, k, v)]
    o = fa.flash_attention(*args, jnp.asarray(mask))
    return np.asarray(o), [np.asarray(t) for t in jax.grad(loss, (0, 1, 2))(*args)]


def _port_flash(q, k, v, mask, g, dtype=torch.float32):
    ts = [torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = tfa.flash_attention(*ts, torch.from_numpy(mask))
    (o.float() * torch.from_numpy(g)).sum().backward()
    return o, [t.grad for t in ts]


# (mask, L, Dh): the three masks at L=128, Dh=32, then the lengths at
# the CUDA kernels' 64-row tile edges and the DeepIce Block's 769, at
# the three head dims (16: RNN_TITO's), with "padding" where it leaves
# every event a valid key
FP32_CASES = [pytest.param(m, 128, 32, id=m) for m in MASKS] + [
    pytest.param(m, L, D, id=f"{m}-L{L}-Dh{D}")
    for D in (32, 64, 16)
    for L in (1, 65, 129, 769)
    for m in ("no_padding", "padding")
    if m == "no_padding" or L >= 65
]


@pytest.mark.parametrize("masks,L,D", FP32_CASES)
def test_flash_fp32_matches_jax(masks, L, D):
    q, k, v, g = _qkvg(L=L, D=D)
    mask = MASKS[masks](L)
    o_j, grads_j = _jax_flash(q, k, v, mask, g)
    o_t, grads_t = _port_flash(q, k, v, mask, g)
    assert o_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.detach().numpy(), o_j, rtol=2e-5, atol=2e-5)
    # with one valid key (fully_masked) the exact dq is 0 and both sides
    # give rounding noise of dp - delta: hence the absolute floor
    for name, got, exp in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(
            got.numpy(), exp, rtol=1e-4, atol=1e-5 + 1e-4 * np.abs(exp).max(),
            err_msg=f"d{name}",
        )
    assert np.isfinite(o_t.detach().numpy()).all()


def _bf16_matches_jax_loosely(L, D):
    q, k, v, g = _qkvg(L=L, D=D, seed=1)
    mask = MASKS["padding"](L)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    o_j = np.asarray(fa.flash_attention(*bf, jnp.asarray(mask)), np.float32)
    o_t, grads = _port_flash(q, k, v, mask, g, torch.bfloat16)
    assert o_t.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in grads)
    np.testing.assert_allclose(o_t.float().detach().numpy(), o_j, rtol=2e-2, atol=2e-2)
    # and against the fp32 result of the same inputs
    o_32, g_32 = _port_flash(q, k, v, mask, g)
    for got, exp in zip([o_t] + grads, [o_32] + g_32):
        exp = exp.detach().numpy()
        err = np.abs(got.float().detach().numpy() - exp).max()
        assert err <= 2e-2 * np.abs(exp).max() + 1e-2, err


def test_flash_bf16_matches_jax_loosely():
    _bf16_matches_jax_loosely(128, 32)


@pytest.mark.parametrize("L,D", [(65, 32), (129, 32), (65, 64), (129, 64),
                                 (65, 16), (129, 16)],
                         ids=["L65-Dh32", "L129-Dh32", "L65-Dh64", "L129-Dh64",
                              "L65-Dh16", "L129-Dh16"])
def test_flash_bf16_matches_jax_loosely_at_tile_edges(L, D):
    """One row past the CUDA kernels' 64-row tiles, the three head dims."""
    _bf16_matches_jax_loosely(L, D)


def test_flash_fully_masked_row_is_uniform_with_finite_lse():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvg(L=64))
    mask = torch.from_numpy(MASKS["fully_masked"](64))
    o, lse = tfa.flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(o[1], v[1].mean(dim=1, keepdim=True).expand_as(o[1]))
    np.testing.assert_allclose(lse[1].numpy(), np.float32(-1e5 + np.log(64)), rtol=0)
    assert lse[1, 0, 0] != -1e5  # log(L) survives beside -1e5 in fp32
    # one valid key: every query row reads that key's value
    torch.testing.assert_close(o[0], v[0, :, :1].expand_as(o[0]))


def test_ragged_fully_masked_row_follows_the_dense_formula():
    """A known divergence (ROADMAP §3): at a ragged L the JAX flash path
    pads to Lp and a fully masked row reads sum(v)/Lp; the port follows
    the dense formula, sum(v)/L, as the JAX dense path does."""
    L = 200
    q, k, v, _ = _qkvg(L=L, seed=3)
    mask = MASKS["fully_masked"](L)
    o_t = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              torch.from_numpy(mask)).numpy()
    dense = v[1].mean(axis=1)  # [H, D]
    np.testing.assert_allclose(o_t[1], np.broadcast_to(dense[:, None], o_t[1].shape),
                               rtol=1e-5, atol=1e-6)
    o_j = np.asarray(fa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                        jnp.asarray(mask)))
    Lp = fa._pick_pad(L)
    assert Lp > L
    np.testing.assert_allclose(o_j[1], np.broadcast_to(dense[:, None] * L / Lp, o_j[1].shape),
                               rtol=1e-5, atol=1e-6)
    # rows with a valid key agree
    np.testing.assert_allclose(o_t[0], o_j[0], rtol=2e-5, atol=2e-5)


def test_flash_wrappers_take_the_plain_version_on_the_cpu_and_check_inputs():
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(L=32))
    mask = torch.from_numpy(MASKS["padding"](32))
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    o, lse = tfa.flash_attention_fwd(q, k, v, mask)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, mask)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = tfa.attention_delta(g, o)
    dq = tfa.flash_attention_bwd_dq(q, k, v, mask, lse, g, delta)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, mask, lse, g, delta)
    exp = tfa.flash_attention_bwd_plain(q, k, v, mask, o, lse, g)
    for got, e in zip((dq, dk, dv), exp):
        assert torch.equal(got, e)
    assert [c.launches for c in counters] == before  # no kernel ran
    with pytest.raises(ValueError, match="shape"):
        tfa.flash_attention(q, k[:, :, :16], v, mask)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention(q, k.double(), v, mask)
    with pytest.raises(ValueError, match="key_padding_mask"):
        tfa.flash_attention(q, k, v, mask.float())
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd_dq(q, k, v, mask, lse.double(), g, delta)
    with pytest.raises(ValueError, match="delta"):
        tfa.flash_attention_bwd_dkv(q, k, v, mask, lse, g, delta[:1])
    # the kernels' own checks, met before any launch
    with pytest.raises(ValueError, match="head dims"):
        tfa._check_kernel(torch.zeros(1, 1, 4, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._check_kernel(torch.zeros(1, 1, 4, 32, dtype=torch.float16))
    assert all(tfa.supported(d) for d in (16, 32, 64))
    assert not tfa.supported(8) and not tfa.supported(128)


def test_aligned16_passes_an_aligned_tensor_through():
    t = torch.randn(4, 32)
    assert t.data_ptr() % 16 == 0
    assert tfa.aligned16(t).data_ptr() == t.data_ptr()


def test_aligned16_copies_an_offset_view_to_aligned_memory():
    base = torch.randn(2 * 64 + 1)
    view = base[1:].view(2, 64)  # contiguous, 4 bytes past an aligned start
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    got = tfa.aligned16(view)
    assert got.data_ptr() % 16 == 0 and got.data_ptr() != view.data_ptr()
    assert torch.equal(got, view)
    bf = torch.randn(65).to(torch.bfloat16)[1:]  # 2 bytes off
    assert bf.data_ptr() % 16 == 2
    got = tfa.aligned16(bf)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, bf)


def test_flash_default_scale_is_applied_to_q_in_its_dtype():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvg(L=16, seed=4))
    o1, _ = tfa.flash_attention_plain(q, k, v)
    o2, _ = tfa.flash_attention_plain(q * (1 / np.sqrt(32)), k, v, scale=1.0)
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    s = torch.tensor(1 / np.sqrt(32), dtype=torch.bfloat16)
    o3, _ = tfa.flash_attention_plain(qb, kb, vb)
    o4, _ = tfa.flash_attention_plain(qb * s, kb, vb, scale=1.0)
    assert torch.equal(o3, o4)


# ---------------------------------------------------------------- layers
def _x_mask(B=2, L=128, D=64, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = np.arange(L)[None, :] < np.array([[100], [L]])
    return x, mask


def _random_tree(tree, seed):
    """The tree's shapes with random values (non-zero biases and norm
    scales, so no layer starts at a degenerate point)."""
    rng = np.random.default_rng(seed)

    def draw(a):
        shape = np.shape(a)
        scale = 1 / np.sqrt(shape[0]) if len(shape) == 2 else 0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, tree)


def _layer_pair(jmod, tmod, args, seed, flash, monkeypatch):
    params = _random_tree(jax.device_get(jmod.init(jax.random.PRNGKey(0), *args)), seed)
    tmod.load_state_dict(params_from_jax(params, tmod.state_dict()))
    if flash:  # the JAX flash path runs where the JAX gate allows it
        monkeypatch.setattr("graphnet_tpu.ops.flash_attention.supported",
                            lambda *a, **k: True)
    else:
        monkeypatch.setattr(MultiHeadAttention, "uses_flash",
                            lambda self, attn_bias=None: False)
    return params


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_multi_head_attention_matches_jax(flash, monkeypatch):
    x, mask = _x_mask()
    jmod = JaxMHA(num_heads=2)
    tmod = MultiHeadAttention(64, 2)
    params = _layer_pair(jmod, tmod, (x, mask), 11, flash, monkeypatch)
    assert tmod.uses_flash() == flash
    exp = np.asarray(jmod.apply(params, x, mask))
    xt = torch.from_numpy(x).requires_grad_()
    got = tmod(xt, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), exp, rtol=2e-5, atol=2e-5)
    # input gradient of a fixed projection of the output
    w = np.random.default_rng(12).standard_normal(exp.shape).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jmod.apply(params, x, mask) * w))(x)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * np.abs(jg).max())


def test_multi_head_attention_bias_takes_the_dense_path():
    x, mask = _x_mask(L=16)
    jmod = JaxMHA(num_heads=2)
    tmod = MultiHeadAttention(64, 2)
    params = _random_tree(jax.device_get(jmod.init(jax.random.PRNGKey(0), x, mask)), 13)
    tmod.load_state_dict(params_from_jax(params, tmod.state_dict()))
    bias = np.random.default_rng(14).standard_normal((2, 2, 16, 16)).astype(np.float32)
    assert not tmod.uses_flash(torch.from_numpy(bias))
    exp = np.asarray(jmod.apply(params, x, mask, bias))
    got = tmod(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(bias))
    np.testing.assert_allclose(got.detach().numpy(), exp, rtol=2e-5, atol=2e-5)
    # attention dropout that is off (deterministic) leaves the route alone
    assert not MultiHeadAttention(64, 2, dropout_rate=0.1).uses_flash(
        torch.from_numpy(bias))
    assert MultiHeadAttention(64, 2, dropout_rate=0.1).uses_flash()


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_transformer_encoder_layer_matches_jax(flash, monkeypatch):
    x, mask = _x_mask(seed=6)
    jmod = JaxEncoder(num_heads=2, dim_feedforward=96)
    tmod = TransformerEncoderLayer(64, 2, dim_feedforward=96)
    params = _layer_pair(jmod, tmod, (x, mask), 15, flash, monkeypatch)
    exp = np.asarray(jmod.apply(params, x, mask))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_dyntrans_matches_jax(flash, monkeypatch):
    x, mask = _x_mask(seed=7, D=32)
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 100, (2, 128, 8)).astype(np.int32)
    em = (rng.random((2, 128, 8)) > 0.2) & mask[..., None]
    jmod = JaxDynTrans(layer_sizes=(32, 64, 64), n_head=2)
    tmod = DynTrans(layer_sizes=(32, 64, 64), n_head=2)
    args = (x, mask, idx, em)
    params = _layer_pair(jmod, tmod, args, 16, flash, monkeypatch)
    assert tmod.conv.tito and not tmod.residual
    exp = np.asarray(jmod.apply(params, *args))
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exp, rtol=2e-4, atol=2e-5)
