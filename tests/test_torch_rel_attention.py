"""The port's relative-bias attention (the plain forward and backward,
through the autograd Function that the card runs with its kernels) and
its ``AttentionRel`` layer against the JAX package on the CPU: the
streaming version, the materialised dense path and the Pallas kernels
in interpret mode (as ``test_rel_flash_attention.py`` runs them)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from graphnet_tpu.models.components.embedding import (
    SpacetimeEncoder as JaxSpacetimeEncoder,
)
from graphnet_tpu.models.components.layers import AttentionRel as JaxAttentionRel
from graphnet_tpu.ops import rel_flash_attention as jrel
from graphnet_tpu_torch.models.components.embedding import SpacetimeEncoder
from graphnet_tpu_torch.models.components.layers import AttentionRel
from graphnet_tpu_torch.ops import rel_flash_attention as trel
from graphnet_tpu_torch.ops import rel_flash_attention_cuda as tcuda
from graphnet_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(2)

B, H, HD = 2, 2, 16


def _x0(rng, L):
    """Pulse coordinates as DeepIce sees them: positions ~N(0, 0.5^2),
    times in [0, 0.03) (both sides of the light cone), charge, aux."""
    return np.concatenate(
        [rng.standard_normal((B, L, 3)) * 0.5, rng.random((B, L, 1)) * 0.03,
         rng.random((B, L, 1)), rng.random((B, L, 1)) > 0.5], axis=-1,
    ).astype(np.float32)


def _inputs(L, seed=0, heads=H, hd=HD):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, heads, L, hd)).astype(np.float32)
                  for _ in range(4))
    q *= np.float32(hd ** -0.5)
    # flax [in, out]
    w = (rng.standard_normal((hd, hd)) / np.sqrt(hd)).astype(np.float32)
    b = (rng.standard_normal(hd) * 0.1).astype(np.float32)
    g = g.transpose(0, 2, 1, 3)  # the output's layout [B, L, H, hd]
    return q, k, v, _x0(rng, L), w, b, g


# event 0 has a ragged count of valid pulses, event 1 all of them
def _mask(L):
    return np.arange(L)[None, :] < np.array([[L * 3 // 4], [L]])


def _jax_out_and_grads(fn, q, k, v, x0, w, b, mask, g):
    def loss(q, k, v, w, b):
        return jnp.sum(fn(q, k, v, jnp.asarray(x0), w, b, jnp.asarray(mask)) * g)

    args = [jnp.asarray(a) for a in (q, k, v, w, b)]
    out = fn(*args[:3], jnp.asarray(x0), *args[3:], jnp.asarray(mask))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    return np.asarray(out), [np.asarray(t) for t in grads]


def _port_out_and_grads(q, k, v, x0, w, b, mask, g, dtype=torch.float32):
    ts = [torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v)]
    weight = torch.tensor(w.T.copy(), requires_grad=True)  # nn.Linear layout
    bias = torch.tensor(b, requires_grad=True)
    out = tcuda.rel_flash_attention(*ts, torch.from_numpy(x0), weight, bias,
                                    torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()
    grads = [t.grad for t in ts] + [weight.grad.T, bias.grad]
    return out.detach(), grads


def _materialised(q, k, v, x0, w, b, mask):
    """AttentionRel's dense biased path with the JAX package's pair
    features: the reference the streaming and kernel versions are held
    to in ``test_rel_flash_attention.py``."""
    rel = jrel.sinusoidal_pair_emb(jrel.pair_distance(x0, x0), w.shape[0]) @ w + b
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k)
    logits = logits + jnp.einsum("bhic,bijc->bhij", q, rel)
    logits = jnp.where(mask[:, None, None, :], logits, jnp.finfo(jnp.float32).min)
    attn = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bhqk,bhkd->bhqd", attn, v).transpose(0, 2, 1, 3)
    return out + jnp.einsum("bhij,bijc->bihc", attn, rel)


# the outputs' absolute floor, above 2e-5: on these inputs the JAX
# streaming and Pallas (interpret) outputs lie 4.3e-5 and 3.8e-5 from a
# float64 evaluation of the same fp32 pair arguments, the port's 5.6e-6
# (measured); near-zero outputs then differ by up to 2.6e-5
OUT_ATOL = 5e-5

REFERENCES = {
    "streaming": lambda q, k, v, x0, w, b, m: jrel.rel_attention_streaming(
        q, k, v, x0, w, b, key_padding_mask=m, ts=32),
    "dense": _materialised,
    "pallas_interpret": lambda q, k, v, x0, w, b, m: jrel.rel_flash_attention(
        q, k, v, x0, w, b, key_padding_mask=m, tq=64, ts=128, interpret=True),
}


_REL_CASES = [("streaming", 128), ("streaming", 100), ("dense", 100),
              ("pallas_interpret", 128)]


@pytest.mark.parametrize(
    "ref,L,hd",
    [pytest.param(r, L, HD, id=f"{r}-{L}") for r, L in _REL_CASES]
    + [pytest.param(r, L, 64, id=f"{r}-{L}-hd64")
       for r, L in _REL_CASES + [("dense", 48)]],
)
def test_rel_attention_matches_jax(ref, L, hd):
    """Outputs and the gradients of q, k, v, W and b, rtol 2e-4 with an
    absolute floor of 2e-5 of each gradient's max.  The outputs' floor is
    OUT_ATOL.  Head dims 16 and 64 (the zoo's ``B_d64``, which the
    kernels take as well)."""
    q, k, v, x0, w, b, g = _inputs(L, hd=hd)
    mask = _mask(L)
    out_j, grads_j = _jax_out_and_grads(REFERENCES[ref], q, k, v, x0, w, b,
                                        mask, g)
    out_t, grads_t = _port_out_and_grads(q, k, v, x0, w, b, mask, g)
    assert out_t.shape == (B, L, H, hd) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=2e-4, atol=OUT_ATOL)
    for name, got, exp in zip(("q", "k", "v", "W", "b"), grads_t, grads_j):
        np.testing.assert_allclose(
            got.numpy(), exp, rtol=2e-4, atol=2e-5 * np.abs(exp).max(),
            err_msg=f"d{name}")


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("L", [1, 63, 65])
def test_rel_dk_dv_match_jax_streaming_at_tile_edges(L, heads):
    """dk and dv of the plain backward (the values the card holds the dkv
    kernel to) against the JAX streaming version at the edges of that
    kernel's 32-key blocks and 16-query tiles, with one head and three
    (at L = 1 event 0 has no valid key): rtol 2e-4, an absolute floor of
    2e-5 of each gradient's max, in each event with a valid key.  At L = 1
    no event has two keys, so ds = dp - delta is rounding noise and dk
    with it (exactly 0 in JAX): its floor is then 2e-5 of dv's max, as
    ``chip_smoke.py``'s ``check_bwd`` holds one-key events.  The event
    with no valid key follows the dense formula, a uniform softmax over
    the L keys: dk exactly 0 and dv the mean of the output gradient over
    the queries (the streaming version pads L to its tile and spreads it
    over 32 keys; ROADMAP.md queue 3)."""
    q, k, v, x0, w, b, g = _inputs(L, seed=L + heads, heads=heads)
    mask = _mask(L)
    _, grads_j = _jax_out_and_grads(REFERENCES["streaming"], q, k, v, x0, w,
                                    b, mask, g)
    _, grads_t = _port_out_and_grads(q, k, v, x0, w, b, mask, g)
    keyed = mask.any(axis=1)
    for name, i in (("k", 1), ("v", 2)):
        exp = grads_j[i][keyed]
        scale = np.abs(exp).max()
        if L == 1:
            scale = max(scale, np.abs(grads_j[2][keyed]).max())
        np.testing.assert_allclose(
            grads_t[i].numpy()[keyed], exp, rtol=2e-4, atol=2e-5 * scale,
            err_msg=f"d{name}")
    if not keyed.all():
        assert not grads_t[1][~keyed].any()
        mean_g = g.transpose(0, 2, 1, 3)[~keyed].mean(axis=2, keepdims=True)
        dv = grads_t[2].numpy()[~keyed]
        np.testing.assert_allclose(dv, np.broadcast_to(mean_g, dv.shape),
                                   rtol=2e-4, atol=2e-5 * np.abs(mean_g).max())


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("L", [1, 15, 17, 31, 33, 65])
def test_rel_dq_matches_jax_at_tile_edges(L, heads):
    """The q, W and b gradients of the plain backward (which dq, dqt and
    dqb feed: the values the card holds the dq kernel to) against the
    JAX package at the edges of that kernel's 16-query blocks and 16-key
    tiles, with one head and three: rtol 2e-4, an absolute floor of 2e-5
    of each gradient's max.  The reference is the materialised dense
    path: at these shapes the JAX streaming version's q and W gradients
    lie 2e-5 to 5e-5 of their max from both the dense path and the port
    (which agree within 3e-7), beyond the floor.  Event 0 has no valid
    key, event 1 a ragged count (one at L = 1, where ds = dp - delta is
    rounding noise and dq with it: its floor is then 2e-5 of dv's max,
    as for dk in the dk/dv test).  W and b are summed over the events and
    a no-key event's value path differs between the kernels' contract
    and the dense path (ROADMAP.md queue 3), so the gradients are
    compared on event 1 alone.  The no-key event follows the dense
    formula: a masked logit is a constant, so dq, dqt and dqb are exactly
    0 there."""
    q, k, v, x0, w, b, g = _inputs(L, seed=3 * L + heads, heads=heads)
    mask = np.zeros((B, L), bool)
    mask[1, :max(1, 3 * L // 4)] = True
    one = [a[1:] for a in (q, k, v, x0)]
    _, grads_j = _jax_out_and_grads(REFERENCES["dense"], *one, w, b, mask[1:],
                                    g[1:])
    _, grads_t = _port_out_and_grads(*one, w, b, mask[1:], g[1:])
    for name, i in (("q", 0), ("W", 3), ("b", 4)):
        exp = grads_j[i]
        scale = np.abs(exp).max()
        if L == 1 and name == "q":
            scale = max(scale, np.abs(grads_j[2]).max())
        np.testing.assert_allclose(grads_t[i].numpy(), exp, rtol=2e-4,
                                   atol=2e-5 * scale, err_msg=f"d{name}")
    _, grads_both = _port_out_and_grads(q, k, v, x0, w, b, mask, g)
    assert not grads_both[0][0].any()
    # the core's own gradients of the no-key event
    qt = torch.from_numpy(q) @ torch.from_numpy(w)
    qb = torch.from_numpy(q) @ torch.from_numpy(b)
    args = (torch.from_numpy(q), qt, qb, torch.from_numpy(k),
            torch.from_numpy(v), torch.from_numpy(x0), torch.from_numpy(mask))
    o, oe, lse = trel.rel_attention_plain(*args)
    do = torch.from_numpy(g.transpose(0, 2, 1, 3).copy())
    doe = do @ torch.from_numpy(w.T.copy())
    delta = trel.rel_attention_delta(do, o, doe, oe)
    dq, dqt, dqb = trel.rel_attention_bwd_plain(*args, lse, do, doe, delta)[:3]
    assert not dq[0].any() and not dqt[0].any() and not dqb[0].any()
    assert dq[1].any() and dqt[1].any()


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("L", [1, 15, 17, 31, 33, 65])
def test_rel_fwd_matches_jax_at_tile_edges(L, heads):
    """The output of the plain forward (through ``rel_flash_attention``:
    the values the card holds the forward kernel to) against the JAX
    package's materialised dense path at the edges of that kernel's
    16-query blocks and 16-key tiles, with one head and three: rtol 2e-4
    with the floor ``OUT_ATOL``.  Event 0 has no valid key, event 1 a
    ragged count (one at L = 1).  Then the core's contract at the same
    shapes, in fp32 and bf16: the no-key event's o is the mean of v over
    the L keys (within 2e-5 of its max in fp32, one bf16 rounding, 1e-2,
    in bf16), and an event whose one key sits in the last tile has that
    key's v as its o, exactly."""
    q, k, v, x0, w, b, _ = _inputs(L, seed=5 * L + heads, heads=heads)
    mask = np.zeros((B, L), bool)
    mask[1, :max(1, 3 * L // 4)] = True
    out_j = np.asarray(_materialised(*(jnp.asarray(a) for a in
                                       (q, k, v, x0, w, b, mask))))
    with torch.no_grad():
        out_t = tcuda.rel_flash_attention(
            *(torch.from_numpy(a) for a in (q, k, v, x0)),
            torch.from_numpy(w.T.copy()), torch.from_numpy(b),
            torch.from_numpy(mask))
    assert out_t.shape == (B, L, heads, HD)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=2e-4, atol=OUT_ATOL)
    one = mask.copy()
    one[1] = False
    one[1, L - 1] = True
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
        qc, kc, vc = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
        qt = qc.float() @ torch.from_numpy(w.T.copy())
        qb = qc.float() @ torch.from_numpy(b)
        o = trel.rel_attention_plain(qc, qt, qb, kc, vc, torch.from_numpy(x0),
                                     torch.from_numpy(one))[0]
        assert o.dtype == dtype
        assert torch.equal(o[1], vc[1, :, L - 1:].expand_as(o[1]))
        mean_v = vc[0].float().mean(dim=1, keepdim=True).expand_as(o[0])
        err = (o[0].float() - mean_v).abs().max()
        assert err <= tol * o[0].float().abs().max(), err


def test_pair_distance_and_freqs_bit_for_bit():
    rng = np.random.default_rng(1)
    xq, xk = _x0(rng, 100), _x0(rng, 37)
    exp = np.asarray(jrel.pair_distance(jnp.asarray(xq), jnp.asarray(xk)))
    got = trel.pair_distance(torch.from_numpy(xq), torch.from_numpy(xk)).numpy()
    assert got.shape == (B, 100, 37) and np.abs(got).max() > 1000.0
    np.testing.assert_array_equal(got, exp)
    for dim in (16, 32, 96, 192):
        np.testing.assert_array_equal(trel._freqs(dim), jrel._freqs(dim))
    emb = trel.sinusoidal_pair_emb(torch.from_numpy(got), 32).numpy()
    np.testing.assert_allclose(
        emb, np.asarray(jrel.sinusoidal_pair_emb(jnp.asarray(exp), 32)),
        rtol=0, atol=1e-6)


def test_zero_pulse_event_is_uniform_and_matches_the_dense_path():
    """An event with no valid pulse (the first BlockRel of a padding
    event): every row uniform over the L keys, o the mean of v, oe the
    mean of the pair embedding, lse = -1e5 + log L, no gradient through
    the logits; at a ragged L as at a multiple of the tile."""
    for L in (100, 128):
        q, k, v, x0, w, b, g = _inputs(L, seed=2)
        mask = _mask(L)
        mask[0] = False
        qt = torch.from_numpy(q) @ torch.from_numpy(w.T.copy())
        qb = torch.from_numpy(q) @ torch.from_numpy(b)
        args = [torch.from_numpy(a) for a in (q,)] + [qt, qb] + [
            torch.from_numpy(a) for a in (k, v, x0, mask)]
        o, oe, lse = trel.rel_attention_plain(*args)
        torch.testing.assert_close(
            o[0], torch.from_numpy(v[0]).mean(dim=1, keepdim=True).expand_as(o[0]))
        emb = trel.sinusoidal_pair_emb(
            trel.pair_distance(args[5][:1], args[5][:1]), HD)[0]  # [L, L, e]
        torch.testing.assert_close(oe[0], emb.mean(dim=1)[None].expand_as(oe[0]))
        np.testing.assert_array_equal(lse[0].numpy(), np.float32(-1e5 + np.log(L)))
        out_j, grads_j = _jax_out_and_grads(_materialised, q, k, v, x0, w, b,
                                            mask, g)
        out_t, grads_t = _port_out_and_grads(q, k, v, x0, w, b, mask, g)
        np.testing.assert_allclose(out_t.numpy(), out_j, rtol=2e-4,
                                   atol=OUT_ATOL)
        # the empty event's dv: p = exp(-1e5 - lse) with lse = -1e5 + log L
        # in fp32, where the spacing at 1e5 (0.0078) leaves p = 1/L within
        # 0.4 % (the kernels' contract; the dense path's p is 1/L exactly)
        dv_t, dv_j = grads_t[2].numpy(), grads_j[2]
        np.testing.assert_allclose(dv_t[0], dv_j[0], rtol=4e-3, atol=0)
        grads_t[2], grads_j[2] = dv_t[1:], dv_j[1:]
        for name, got, exp in zip(("q", "k", "v", "W", "b"), grads_t, grads_j):
            np.testing.assert_allclose(
                np.asarray(got), exp, rtol=2e-4, atol=2e-5 * np.abs(exp).max(),
                err_msg=f"d{name} at L={L}")
        assert not grads_t[0][0].any() and not grads_t[1][0].any()


def test_rel_attention_bf16_plain_near_fp32():
    """bf16 q, k, v: o in bf16, every gradient finite and near the fp32
    result of the same inputs."""
    q, k, v, x0, w, b, g = _inputs(64, seed=3)
    mask = _mask(64)
    out32, grads32 = _port_out_and_grads(q, k, v, x0, w, b, mask, g)
    out16, grads16 = _port_out_and_grads(q, k, v, x0, w, b, mask, g,
                                         torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in grads16[:3])
    for got, exp in zip([out16] + grads16, [out32] + grads32):
        exp = exp.numpy()
        err = np.abs(got.float().numpy() - exp).max()
        assert np.isfinite(got.float().numpy()).all()
        assert err <= 3e-2 * np.abs(exp).max(), err


def test_rel_wrappers_take_the_plain_versions_on_the_cpu_and_check_inputs():
    q, k, v, x0, w, b, g = (torch.from_numpy(a) for a in _inputs(48, seed=4))
    mask = torch.from_numpy(_mask(48))
    qt, qb = q @ w.T, q @ b
    counters = (tcuda.rel_attention_fwd, tcuda.rel_attention_bwd_dq,
                tcuda.rel_attention_bwd_dkv)
    before = [c.launches for c in counters]
    o, oe, lse = tcuda.rel_attention_fwd(q, qt, qb, k, v, x0, mask)
    exp = trel.rel_attention_plain(q, qt, qb, k, v, x0, mask)
    assert all(torch.equal(a, e) for a, e in zip((o, oe, lse), exp))
    do, doe = torch.randn_like(o), torch.randn_like(oe)
    delta = trel.rel_attention_delta(do, o, doe, oe)
    args = (q, qt, qb, k, v, x0, mask, lse, do, doe, delta)
    got = tcuda.rel_attention_bwd_dq(*args) + tcuda.rel_attention_bwd_dkv(*args)
    for a, e in zip(got, trel.rel_attention_bwd_plain(*args)):
        assert torch.equal(a, e)
    assert [c.launches for c in counters] == before  # no kernel ran
    with pytest.raises(ValueError, match="shape"):
        tcuda.rel_attention_fwd(q, qt, qb, k[:, :, :16], v, x0, mask)
    with pytest.raises(ValueError, match="qt"):
        tcuda.rel_attention_fwd(q, qt[..., :8], qb, k, v, x0, mask)
    with pytest.raises(ValueError, match="x0"):
        tcuda.rel_attention_fwd(q, qt, qb, k, v, x0[..., :3], mask)
    with pytest.raises(ValueError, match="mask"):
        tcuda.rel_attention_fwd(q, qt, qb, k, v, x0, mask.float())
    with pytest.raises(ValueError, match="lse"):
        tcuda.rel_attention_bwd_dq(q, qt, qb, k, v, x0, mask, lse[0], do, doe,
                                   delta)
    for hd in (16, 32, 64):
        tcuda._check_kernel(torch.zeros(1, 1, 4, hd))
        tcuda._check_kernel(torch.zeros(1, 1, 4, hd, dtype=torch.bfloat16))
    for hd in (48, 128):
        with pytest.raises(ValueError, match="head dims"):
            tcuda._check_kernel(torch.zeros(1, 1, 4, hd))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tcuda._check_kernel(torch.zeros(1, 1, 4, 32, dtype=torch.float16))
    # the gate: pair dim = head dim, a head dim the kernels are built for
    assert trel.supported(32, 32) and trel.supported(16, 16)
    assert trel.supported(64, 64)
    assert not trel.supported(32, 16) and not trel.supported(48, 48)
    assert not trel.supported(128, 128)


class _JaxRelLayer(fnn.Module):
    """AttentionRel with a SpacetimeEncoder as its relative source."""

    rel_flash: str
    hd: int = HD

    @fnn.compact
    def __call__(self, x, x0, mask):
        enc = JaxSpacetimeEncoder(self.hd, name="rel_pos")
        return JaxAttentionRel(H, qkv_bias=True, rel_flash=self.rel_flash,
                               name="attn")(x, x, x, key_padding_mask=mask,
                                            rel_source=(enc, x0))


class _PortRelLayer(torch.nn.Module):
    def __init__(self, rel_flash, hd=HD):
        super().__init__()
        self.rel_pos = SpacetimeEncoder(hd)
        self.attn = AttentionRel(H * hd, H, qkv_bias=True, rel_flash=rel_flash)

    def forward(self, x, x0, mask):
        return self.attn(x, x, x, key_padding_mask=mask,
                         rel_source=(self.rel_pos, x0))


@pytest.mark.parametrize(
    "rel_flash,hd,jax_rel_flash",
    [pytest.param(r, HD, r, id=r) for r in ("never", "always")]
    + [pytest.param("never", 64, "never", id="never-hd64"),
       pytest.param("always", 64, "never", id="always-hd64")],
)
def test_attention_rel_layer_matches_jax(rel_flash, hd, jax_rel_flash):
    """The layer with its projections: the dense path ("never": JAX's
    single-chunk path, the port's materialised one) and the kernel path
    ("always": JAX's Pallas kernel in interpret mode, the port's plain
    versions), output and input gradient, at head dims 16 and 64.  At
    hd 64 the port's kernel path is held against JAX's dense path: on
    these inputs JAX's Pallas kernel (interpret mode) lies 2.3e-5 of the
    input gradient's max from JAX's own dense path, the port's plain
    versions 3.4e-6 (measured); the core alone is held against the
    Pallas kernel at hd 64 in ``test_rel_attention_matches_jax``."""
    L = 128
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, L, H * hd)).astype(np.float32)
    x0, mask = _x0(rng, L), _mask(L)
    jmod = _JaxRelLayer(jax_rel_flash, hd)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), x, x0, mask))
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape)
                   * (1 / np.sqrt(a.shape[0]) if a.ndim == 2 else 0.3)
                   ).astype(np.float32), params)
    tmod = _PortRelLayer(rel_flash, hd)
    tmod.load_state_dict(params_from_jax(params, tmod.state_dict()))
    assert tmod.attn.uses_rel_kernel(hd) == (rel_flash == "always")
    gw = rng.standard_normal(x.shape).astype(np.float32)
    exp = np.asarray(jmod.apply(params, x, x0, mask))
    jg = jax.grad(lambda x: jnp.sum(jmod.apply(params, x, x0, mask) * gw))(x)
    xt = torch.from_numpy(x).requires_grad_()
    got = tmod(xt, torch.from_numpy(x0), torch.from_numpy(mask))
    (got * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), exp, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=2e-4,
                               atol=2e-5 * np.abs(jg).max())


@pytest.mark.parametrize("hd", [16, 64])
def test_plain_backwards_unrounded_round_to_their_outputs(hd):
    """``out_dtype=torch.float32`` gives the plain backwards' bf16
    gradients before their last rounding (what ``chip_smoke.py`` holds
    the kernels to): rounded, they are the default outputs bit for bit;
    dqt and dqb are fp32 either way."""
    from graphnet_tpu_torch.ops import flash_attention_cuda as tfa

    L = 40
    q, k, v, x0, w, b, g = _inputs(L, seed=7, hd=hd)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    mask = torch.from_numpy(_mask(L))
    qt = q.float() @ torch.from_numpy(w)
    qb = q.float() @ torch.from_numpy(b)
    x0 = torch.from_numpy(x0)
    o, oe, lse = trel.rel_attention_plain(q, qt, qb, k, v, x0, mask)
    do = torch.from_numpy(g).transpose(1, 2).to(torch.bfloat16)
    doe = torch.randn(oe.shape, generator=torch.Generator().manual_seed(hd))
    args = (q, qt, qb, k, v, x0, mask, lse, do, doe,
            trel.rel_attention_delta(do, o, doe, oe))
    rounded = trel.rel_attention_bwd_plain(*args)
    exact = trel.rel_attention_bwd_plain(*args, out_dtype=torch.float32)
    for r, e in zip(rounded, exact):
        assert e.dtype == torch.float32 and torch.equal(e.to(r.dtype), r)
    fo, flse = tfa.flash_attention_plain(q, k, v, mask)
    rounded = tfa.flash_attention_bwd_plain(q, k, v, mask, fo, flse, do)
    exact = tfa.flash_attention_bwd_plain(q, k, v, mask, fo, flse, do,
                                          out_dtype=torch.float32)
    for r, e in zip(rounded, exact):
        assert r.dtype == torch.bfloat16 and e.dtype == torch.float32
        assert torch.equal(e.to(torch.bfloat16), r)
