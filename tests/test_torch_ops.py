"""The port's plain ops against the JAX package on the CPU: kNN (XLA path
and the Pallas kernel in interpret mode), the fused EdgeConv forward
(Pallas interpret mode) and the masked reductions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.ops import gather_reduce as jgr
from graphnet_tpu.ops.edgeconv_pallas import fused_edgeconv as jax_fused
from graphnet_tpu.ops.knn import knn_graph as jax_knn_graph
from graphnet_tpu.ops.knn_pallas import knn_graph_pallas
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.ops import gather_reduce as tgr
from graphnet_tpu_torch.ops.edgeconv_cuda import (
    fused_edgeconv,
    fused_edgeconv_plain,
)
from graphnet_tpu_torch.ops.knn import knn_graph, pairwise_sq_dists
from graphnet_tpu_torch.ops.knn_cuda import knn_graph_cuda

torch.set_num_threads(2)


def _ragged_events(rng, B, L, d=3, scale=50.0):
    lens = [int(rng.integers(L // 2, L + 1)) for _ in range(B - 1)] + [1]
    return [
        (rng.standard_normal((n, d)) * scale).astype(np.float32)
        for n in lens
    ]


def _grid_events(rng):
    """Integer grids in shuffled node order: every distance is exact, so
    many ties are exact and only the lower-index rule decides them (the
    means 1.5 / 0.5 are exact too, so centring stays exact)."""
    g4 = np.stack(
        np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1
    ).reshape(-1, 3)
    g2 = np.stack(
        np.meshgrid(np.arange(2), np.arange(2), np.arange(4), indexing="ij"),
        -1,
    ).reshape(-1, 3)
    return [
        rng.permutation(g4).astype(np.float32),
        rng.permutation(g2).astype(np.float32),
    ]


def _reference_knn(x, mask, k):
    """Brute force in float64: sort keys by (distance, index)."""
    B, L, _ = x.shape
    idx = np.zeros((B, L, k), np.int64)
    em = np.zeros((B, L, k), bool)
    for e in range(B):
        valid = np.flatnonzero(mask[e])
        for q in valid:
            keys = [j for j in valid if j != q]
            d = ((x[e, keys].astype(np.float64) - x[e, q]) ** 2).sum(-1)
            order = np.lexsort((np.asarray(keys), d))[:k]
            n = len(order)
            idx[e, q, :n] = np.asarray(keys)[order]
            em[e, q, :n] = True
    return idx, em


def _assert_same_graph(i_ref, m_ref, i, m):
    np.testing.assert_array_equal(m, m_ref)
    np.testing.assert_array_equal(np.where(m, i, -1), np.where(m_ref, i_ref, -1))


@pytest.mark.parametrize("L", [16, 64])
def test_knn_matches_jax_xla_and_pallas(L):
    rng = np.random.default_rng(L)
    events = _ragged_events(rng, B=4, L=L)
    jb = jax_make_batch(events, length=L)
    i_x, m_x = map(np.asarray, jax_knn_graph(jb.x, jb.mask, k=8))
    with pltpu.force_tpu_interpret_mode():
        i_p, m_p = map(
            np.asarray, knn_graph_pallas(jb.x, jb.mask, k=8, tile=min(L, 128))
        )
    tb = make_batch(events, length=L)
    i_t, m_t = (t.numpy() for t in knn_graph(tb.x, tb.mask, k=8))
    assert i_t.dtype == np.int32 and m_t.dtype == bool
    _assert_same_graph(i_x, m_x, i_t, m_t)
    _assert_same_graph(i_p, m_p, i_t, m_t)
    # the 1-node event has no edge at all
    assert not m_t[-1].any()


def test_knn_with_self_loops_matches_jax():
    rng = np.random.default_rng(9)
    events = _ragged_events(rng, B=3, L=32)
    jb = jax_make_batch(events, length=32)
    i_x, m_x = map(
        np.asarray, jax_knn_graph(jb.x, jb.mask, k=8, exclude_self=False)
    )
    tb = make_batch(events, length=32)
    i_t, m_t = (
        t.numpy() for t in knn_graph(tb.x, tb.mask, k=8, exclude_self=False)
    )
    _assert_same_graph(i_x, m_x, i_t, m_t)
    # each valid node is its own nearest neighbour
    q = np.broadcast_to(np.arange(32), i_t.shape[:2])
    np.testing.assert_array_equal(i_t[..., 0][m_t[..., 0]], q[m_t[..., 0]])


def test_knn_integer_grid_ties_go_to_lower_index():
    rng = np.random.default_rng(3)
    events = _grid_events(rng)
    L = 64
    jb = jax_make_batch(events, length=L)
    i_x, m_x = map(np.asarray, jax_knn_graph(jb.x, jb.mask, k=8))
    with pltpu.force_tpu_interpret_mode():
        i_p, m_p = map(
            np.asarray, knn_graph_pallas(jb.x, jb.mask, k=8, tile=L)
        )
    tb = make_batch(events, length=L)
    i_t, m_t = (t.numpy() for t in knn_graph(tb.x, tb.mask, k=8))
    i_r, m_r = _reference_knn(tb.x.numpy(), tb.mask.numpy(), 8)
    _assert_same_graph(i_r, m_r, i_t, m_t)
    _assert_same_graph(i_x, m_x, i_t, m_t)
    _assert_same_graph(i_p, m_p, i_t, m_t)


def test_knn_wrapper_routes_cpu_to_plain_and_checks_inputs():
    rng = np.random.default_rng(5)
    tb = make_batch(_ragged_events(rng, B=3, L=32), length=32)
    before = knn_graph_cuda.launches
    i1, m1 = knn_graph_cuda(tb.x, tb.mask, 8)
    i2, m2 = knn_graph(tb.x, tb.mask, k=8)
    assert knn_graph_cuda.launches == before  # the plain version ran
    assert torch.equal(i1, i2) and torch.equal(m1, m2)
    with pytest.raises(TypeError):
        knn_graph_cuda(tb.x, tb.mask.float(), 8)
    with pytest.raises(ValueError):
        knn_graph_cuda(tb.x[0], tb.mask, 8)


def test_pairwise_sq_dists_matches_jax():
    from graphnet_tpu.ops.knn import pairwise_sq_dists as jax_d2

    rng = np.random.default_rng(7)
    events = _ragged_events(rng, B=3, L=32)
    jb = jax_make_batch(events, length=32)
    tb = make_batch(events, length=32)
    np.testing.assert_allclose(
        pairwise_sq_dists(tb.x, tb.mask).numpy(),
        np.asarray(jax_d2(jb.x, jb.mask)),
        rtol=1e-5,
        atol=1e-2,  # |x|^2 ~ 1e4 here: fp32 cancellation in both
    )


def _edge_inputs(seed, B=2, L=32, H1=16, H2=8, k=4):
    rng = np.random.default_rng(seed)
    return dict(
        a=rng.standard_normal((B, L, H1)).astype(np.float32),
        b=rng.standard_normal((B, L, H1)).astype(np.float32),
        idx=rng.integers(0, L, (B, L, k)).astype(np.int32),
        em=rng.random((B, L, k)) > 0.3,
        w2=rng.standard_normal((H1, H2)).astype(np.float32),
        b2=rng.standard_normal((H2,)).astype(np.float32),
    )


@pytest.mark.parametrize(
    "aggr,slope", [("add", 0.0), ("max", 0.01), ("add", 0.01), ("max", 0.0)]
)
def test_fused_edgeconv_plain_matches_pallas(aggr, slope):
    inp = _edge_inputs(seed=11)
    inp["em"][0, 3] = False  # a node with no valid edge
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(
            jax_fused(
                *(jnp.asarray(v) for v in inp.values()), 32, aggr, slope
            )
        )
    got = fused_edgeconv(
        *(torch.from_numpy(v) for v in inp.values()), aggr=aggr, slope=slope
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[0, 3], 0.0)


def test_fused_edgeconv_plain_bf16_matches_pallas():
    inp = _edge_inputs(seed=12)
    cast = ("a", "b", "w2", "b2")
    jin = {
        k: jnp.asarray(v).astype(jnp.bfloat16) if k in cast else jnp.asarray(v)
        for k, v in inp.items()
    }
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_fused(*jin.values(), 32, "add", 0.0))
    tin = {
        k: torch.from_numpy(v).to(torch.bfloat16)
        if k in cast
        else torch.from_numpy(v)
        for k, v in inp.items()
    }
    got = fused_edgeconv_plain(*tin.values(), aggr="add", slope=0.0)
    # same bf16 operands, fp32 accumulation on both sides: only the
    # summation order differs
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-4, atol=1e-4)


def test_fused_edgeconv_checks_inputs():
    t = {k: torch.from_numpy(v) for k, v in _edge_inputs(seed=13).items()}
    with pytest.raises(ValueError):
        fused_edgeconv(t["a"], t["b"][:, :8], t["idx"], t["em"], t["w2"], t["b2"])
    with pytest.raises(TypeError):
        fused_edgeconv(
            t["a"], t["b"], t["idx"], t["em"], t["w2"].double(), t["b2"]
        )
    with pytest.raises(ValueError):
        fused_edgeconv(*t.values(), aggr="mean")


@pytest.mark.parametrize("aggr", ["add", "sum", "mean", "max", "min"])
def test_edge_reduce_matches_jax(aggr):
    rng = np.random.default_rng(17)
    msgs = rng.standard_normal((2, 8, 4, 5)).astype(np.float32)
    em = rng.random((2, 8, 4)) > 0.4
    em[1, 2] = False  # empty segment -> 0
    got = tgr.edge_reduce(torch.from_numpy(msgs), torch.from_numpy(em), aggr)
    exp = np.asarray(jgr.edge_reduce(jnp.asarray(msgs), jnp.asarray(em), aggr))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[1, 2], 0.0)


def test_pooling_broadcast_and_homophily_match_jax():
    rng = np.random.default_rng(19)
    x = rng.standard_normal((3, 16, 4)).astype(np.float32)
    mask = rng.random((3, 16)) > 0.3
    mask[2] = False  # an all-masked event pools to 0
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    for name in tgr.POOLS:
        np.testing.assert_allclose(
            tgr.POOLS[name](tx, tm).numpy(),
            np.asarray(jgr.POOLS[name](jx, jm)),
            rtol=1e-5,
            atol=1e-6,
            err_msg=name,
        )
    schemes = ("min", "max", "mean", "sum")
    np.testing.assert_allclose(
        tgr.global_pool(tx, tm, schemes).numpy(),
        np.asarray(jgr.global_pool(jx, jm, schemes)),
        rtol=1e-5,
        atol=1e-6,
    )
    g = rng.standard_normal((3, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tgr.broadcast_to_nodes(torch.from_numpy(g), 16).numpy(),
        np.asarray(jgr.broadcast_to_nodes(jnp.asarray(g), 16)),
    )
    # integer-valued features so equal endpoints are common
    vals = rng.integers(0, 3, (3, 16, 4)).astype(np.float32)
    idx = rng.integers(0, 16, (3, 16, 8)).astype(np.int32)
    em = rng.random((3, 16, 8)) > 0.3
    for v in (vals, vals[..., 0]):
        np.testing.assert_allclose(
            tgr.homophily(
                torch.from_numpy(idx), torch.from_numpy(em), torch.from_numpy(v)
            ).numpy(),
            np.asarray(
                jgr.homophily(jnp.asarray(idx), jnp.asarray(em), jnp.asarray(v))
            ),
            rtol=1e-6,
        )


def test_gather_neighbors_matches_jax():
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 8, 3)).astype(np.float32)
    idx = rng.integers(0, 8, (2, 8, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tgr.gather_neighbors(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
        np.asarray(jgr.gather_neighbors(jnp.asarray(x), jnp.asarray(idx))),
    )
