"""The port's plain ops against the JAX package on the CPU: kNN (XLA path
and the Pallas kernel in interpret mode), the fused EdgeConv forward and
its gradients through the port's autograd Function (Pallas interpret
mode on the JAX side) and the masked reductions."""

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
    pad_operands,
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


@pytest.mark.parametrize("L", [16, 64])
def test_knn_4d_matches_jax_and_brute_force(L):
    """TITO's graph: x, y, z, t (D=4)."""
    rng = np.random.default_rng(40 + L)
    events = _ragged_events(rng, B=4, L=L, d=4)
    jb = jax_make_batch(events, length=L)
    i_x, m_x = map(np.asarray, jax_knn_graph(jb.x, jb.mask, k=8))
    with pltpu.force_tpu_interpret_mode():
        i_p, m_p = map(
            np.asarray, knn_graph_pallas(jb.x, jb.mask, k=8, tile=min(L, 128))
        )
    tb = make_batch(events, length=L)
    i_t, m_t = (t.numpy() for t in knn_graph(tb.x, tb.mask, k=8))
    i_r, m_r = _reference_knn(tb.x.numpy(), tb.mask.numpy(), 8)
    _assert_same_graph(i_r, m_r, i_t, m_t)
    _assert_same_graph(i_x, m_x, i_t, m_t)
    _assert_same_graph(i_p, m_p, i_t, m_t)
    assert not m_t[-1].any()


def test_knn_kernel_takes_only_3_or_4_coordinates():
    from graphnet_tpu_torch.ops.knn_cuda import DIMS, _knn_cuda

    assert DIMS == (3, 4)
    mask = torch.ones(2, 16, dtype=torch.bool)
    for d in (2, 5):
        with pytest.raises(ValueError, match="D in"):
            _knn_cuda(torch.zeros(2, 16, d), mask, 8, True)
    # on the CPU the plain version takes any D
    idx, em = knn_graph_cuda(torch.randn(2, 16, 5), mask, 8)
    assert idx.shape == (2, 16, 8) and bool(em.all())


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


def _kernel_centre_rule(x, mask):
    """``csrc/knn.cu``'s centre, mirrored in numpy: per coordinate, a sum
    in any order where the exponent test proves every float64 addition
    exact (here numpy's pairwise sum of the values reversed), else the
    serial float64 sum in index order; divided by the count (at least 1)
    and rounded once to float32.  Returns the centre and which
    coordinates took the parallel sum."""
    B, _, D = x.shape
    centre = np.zeros((B, D), np.float32)
    parallel = np.zeros((B, D), bool)
    for b in range(B):
        v = x[b, mask[b]]
        n = len(v)
        clog = int(np.ceil(np.log2(n))) if n > 1 else 0
        for d in range(D):
            col = v[:, d]
            nz = col[col != 0]
            e = np.maximum((nz.view(np.uint32) >> 23) & 0xFF, 1)
            lo, hi = (e.min(), e.max()) if nz.size else (255, 0)
            if hi < 255 and hi - lo + 24 + clog <= 53:
                s = np.sum(col[::-1].astype(np.float64)) + 0.0
                parallel[b, d] = True
            else:
                s = 0.0
                for c in col:
                    s += float(c)
            centre[b, d] = np.float32(s / max(n, 1))
    return centre, parallel


def _tie_event(L=64, D=3):
    """Four valid nodes whose float64 sum depends on the order: in index
    order the two half-ulp terms 2^-51 are each absorbed (ties to even),
    so the sum is 4 + 2^-22 and the centre 1 + 2^-24 rounds to 1.0;
    added to each other first they give 4 + 2^-22 + 2^-50 and the centre
    rounds up to 1 + 2^-23.  The exponent test sends it to the serial
    sum."""
    x = np.zeros((1, L, D), np.float32)
    mask = np.zeros((1, L), bool)
    for j, v in ((0, 4.0), (1, 2.0 ** -22), (2, 2.0 ** -51), (18, 2.0 ** -51)):
        x[0, j], mask[0, j] = v, True
    return x, mask


@pytest.mark.parametrize("kind", ["detector", "wide", "masked", "tiny", "tie"])
def test_knn_centre_is_the_kernels_rule_bit_for_bit(kind):
    """The plain version's centre (serial float64 sum in index order)
    equals the kernel's stated rule bit for bit: the parallel sum where
    the exponent test passes, the serial sum where it fails."""
    from graphnet_tpu_torch.ops.knn import event_centre

    rng = np.random.default_rng(len(kind))
    B, L, D = 6, 48, 4
    if kind == "tie":
        x, mask = _tie_event(L, D)
    else:
        scale = {"detector": 500.0, "wide": 1.0, "masked": 50.0, "tiny": 1e-38}[kind]
        x = (rng.standard_normal((B, L, D)) * scale).astype(np.float32)
        if kind == "wide":  # exponent spans of 2^4 to 2^80 by event
            w = np.array([2, 5, 10, 20, 30, 40])[:, None, None]
            x *= (2.0 ** rng.integers(-w, w, (B, L, D))).astype(np.float32)
        mask = np.arange(L)[None] < rng.integers(0, L + 1, B)[:, None]
        if kind == "masked":
            mask &= rng.random((B, L)) > 0.3
            mask[0] = False
            x[1, :, 2] = 0.0
    centre, parallel = _kernel_centre_rule(x, mask)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    got = event_centre(xt, mt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), centre.view(np.uint32))
    if kind == "tie":
        assert not parallel.any()
        assert centre[0, 0] == 1.0
        s = np.float64(4.0) + 2.0 ** -22 + (2.0 ** -51 + 2.0 ** -51)
        assert np.float32(s / 4) == np.float32(1 + 2.0 ** -23)  # the order matters
    if kind == "wide":
        assert parallel.any() and not parallel.all()
    if kind == "detector":
        assert parallel.all()


def test_knn_on_a_strided_view_equals_a_contiguous_copy():
    """``coordinate_view`` of a contiguous column range is a view, and the
    kNN of that view equals the kNN of its contiguous copy; other column
    sets are an index copy."""
    from graphnet_tpu_torch.ops.knn import coordinate_view

    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((3, 40, 7)).astype(np.float32))
    mask = torch.arange(40)[None] < torch.tensor([40, 25, 3])[:, None]
    for cols in ((0, 1, 2), (2, 3, 4), (1, 2, 3, 4)):
        v = coordinate_view(x, cols)
        assert v.data_ptr() == x[..., cols[0]:].data_ptr()
        assert v.stride() == (280, 7, 1) and v.shape[-1] == len(cols)
        i1, m1 = knn_graph(v, mask, k=8)
        i2, m2 = knn_graph(v.contiguous(), mask, k=8)
        assert torch.equal(m1, m2) and torch.equal(i1, i2)
        assert torch.equal(v, x[..., list(cols)])
    picked = coordinate_view(x, (0, 2, 4))
    assert picked.is_contiguous() and torch.equal(picked, x[..., [0, 2, 4]])


def test_knn_launch_checks_refuse_what_the_kernel_does_not_take():
    """``check_launch``, the CUDA wrapper's validation, raises without
    launching: a last stride other than 1, a non-bool mask, D outside
    {3, 4}, k outside [1, L], and (checked last) tensors that are not on
    a CUDA device.  k past 32 and L past the first kernel's
    shared-memory limit are taken (the rounds kernel answers them): only
    the device is refused there."""
    from graphnet_tpu_torch.ops.knn_cuda import MAX_L, check_launch, uses_rounds

    x = torch.zeros(2, 16, 6)
    mask = torch.ones(2, 16, dtype=torch.bool)
    with pytest.raises(ValueError, match="stride"):
        check_launch(x[..., ::2], mask, 8)
    with pytest.raises(ValueError, match="stride"):
        check_launch(x[..., :3], torch.ones(2, 32, dtype=torch.bool)[:, ::2], 8)
    with pytest.raises(TypeError, match="bool"):
        check_launch(x[..., :3], mask.to(torch.uint8), 8)
    with pytest.raises(TypeError, match="float32"):
        check_launch(x[..., :3].double(), mask, 8)
    for d in (2, 5):
        with pytest.raises(ValueError, match="D in"):
            check_launch(x[..., :d], mask, 8)
    for k in (0, 17):
        with pytest.raises(ValueError, match="k="):
            check_launch(x[..., :3], mask, k)
    x64, mask64 = torch.zeros(2, 64, 3), torch.ones(2, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"k=65 must lie in \[1, L=64\]"):
        check_launch(x64, mask64, 65)
    for k in (17, 32, 33, 64):  # taken: only the device is refused
        with pytest.raises(ValueError, match="CUDA device"):
            check_launch(x64, mask64, k)
    big = torch.zeros(1, MAX_L + 1, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        check_launch(big, torch.ones(1, MAX_L + 1, dtype=torch.bool), 8)
    # the rules still refuse a bad D, dtype or stride at L > MAX_L
    big_mask = torch.ones(1, MAX_L + 1, dtype=torch.bool)
    with pytest.raises(ValueError, match="D in"):
        check_launch(torch.zeros(1, MAX_L + 1, 5), big_mask, 8)
    with pytest.raises(TypeError, match="float32"):
        check_launch(big.double(), big_mask, 8)
    with pytest.raises(ValueError, match="stride"):
        check_launch(torch.zeros(1, MAX_L + 1, 6)[..., ::2], big_mask, 8)
    assert [uses_rounds(64, k) for k in (32, 33)] == [False, True]
    assert [uses_rounds(L, 8) for L in (MAX_L, MAX_L + 1)] == [False, True]
    with pytest.raises(ValueError, match="CUDA device"):
        check_launch(x[..., 1:4], mask, 8)


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


# (aggr, slope, H1, H2, k, dtype): the first four cases at the layer
# shape of 16 -> 8 with k = 4; then widths that are no multiple of 16
# (the CUDA wrapper pads them to multiples of 8), k = 1 and 3, and bf16
# operands with max and the leaky slope.  Indices stay in [0, L): the
# JAX selection matmul gives an out-of-range edge b = 0 and keeps it,
# the port drops it (the kNN never makes one)
@pytest.mark.parametrize(
    "aggr,slope,H1,H2,k,dtype",
    [
        pytest.param("add", 0.0, 16, 8, 4, "float32", id="add-0.0"),
        pytest.param("max", 0.01, 16, 8, 4, "float32", id="max-0.01"),
        pytest.param("add", 0.01, 16, 8, 4, "float32", id="add-0.01"),
        pytest.param("max", 0.0, 16, 8, 4, "float32", id="max-0.0"),
        pytest.param("add", 0.0, 20, 12, 1, "float32", id="add-0.0-H1_20-H2_12-k1"),
        pytest.param("max", 0.01, 20, 12, 3, "float32", id="max-0.01-H1_20-H2_12-k3"),
        pytest.param("add", 0.01, 36, 10, 3, "float32", id="add-0.01-H1_36-H2_10-k3"),
        pytest.param("max", 0.0, 12, 20, 1, "float32", id="max-0.0-H1_12-H2_20-k1"),
        pytest.param("max", 0.01, 16, 8, 4, "bfloat16", id="bf16-max-0.01"),
        pytest.param("max", 0.01, 20, 12, 3, "bfloat16", id="bf16-max-0.01-H1_20-H2_12-k3"),
        pytest.param("add", 0.0, 36, 10, 1, "bfloat16", id="bf16-add-0.0-H1_36-H2_10-k1"),
        pytest.param("max", 0.0, 12, 20, 1, "bfloat16", id="bf16-max-0.0-H1_12-H2_20-k1"),
    ],
)
def test_fused_edgeconv_plain_matches_pallas(aggr, slope, H1, H2, k, dtype):
    inp = _edge_inputs(seed=11, H1=H1, H2=H2, k=k)
    inp["em"][0, 3] = False  # a node with no valid edge
    cast = ("a", "b", "w2", "b2") if dtype == "bfloat16" else ()
    jin = [jnp.asarray(v).astype(jnp.bfloat16) if n in cast else jnp.asarray(v)
           for n, v in inp.items()]
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_fused(*jin, 32, aggr, slope))
    got = fused_edgeconv(
        *(torch.from_numpy(v).to(torch.bfloat16) if n in cast
          else torch.from_numpy(v) for n, v in inp.items()),
        aggr=aggr, slope=slope,
    )
    assert got.dtype == torch.float32
    # fp32 throughout, or the same bf16 operands with fp32 sums: only the
    # summation order differs
    tol = 1e-5 if dtype == "float32" else 1e-4
    np.testing.assert_allclose(got.numpy(), expected, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.numpy()[0, 3], 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_operands_keeps_the_output_and_reads_w2_anew(dtype):
    """The CUDA wrappers' padding to multiples of 8: the first H2 output
    columns unchanged, the padded ones 0, nothing copied where the widths
    already fit, and a W2 changed in place (as Adam does) read anew."""
    t = {n: torch.from_numpy(v) for n, v in
         _edge_inputs(seed=14, H1=20, H2=12, k=3).items()}
    for n in ("a", "b", "w2", "b2"):
        t[n] = t[n].to(dtype)
    args = (t["a"], t["b"], t["w2"], t["b2"])
    a, b, w2, b2 = pad_operands(*args)
    assert a.shape[-1] == b.shape[-1] == 24 and w2.shape == (24, 16)
    assert b2.shape == (16,)
    ref = fused_edgeconv_plain(t["a"], t["b"], t["idx"], t["em"], t["w2"],
                               t["b2"], "max", 0.01)
    got = fused_edgeconv_plain(a, b, t["idx"], t["em"], w2, b2, "max", 0.01)
    torch.testing.assert_close(got[..., :12], ref, rtol=1e-6, atol=1e-6)
    assert not got[..., 12:].any()
    assert all(x is y for x, y in zip(pad_operands(a, b, w2, b2), (a, b, w2, b2)))
    t["w2"].mul_(-2.0)  # in place
    w2_new = pad_operands(*args)[2]
    assert torch.equal(w2_new[:20, :12], t["w2"]) and not w2_new[20:].any()
    after = fused_edgeconv(t["a"], t["b"], t["idx"], t["em"], t["w2"],
                           t["b2"], aggr="max", slope=0.01)
    assert not torch.allclose(after, ref)


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


def _grads_jax(inp, cot, aggr, slope, mean, dtype=None):
    """``jax.grad`` of ``sum(out * cot)`` through the JAX fused EdgeConv
    (Pallas interpret mode) in a, b, w2 and b2."""
    import jax

    cast = (lambda v: jnp.asarray(v).astype(dtype)) if dtype else jnp.asarray
    a, b, w2, b2 = (cast(inp[n]) for n in ("a", "b", "w2", "b2"))
    idx, em = jnp.asarray(inp["idx"]), jnp.asarray(inp["em"])

    def loss(a, b, w2, b2):
        out = jax_fused(a, b, idx, em, w2, b2, 32, aggr, slope)
        if mean:
            out = out / jnp.maximum(jnp.sum(em, axis=2)[..., None], 1)
        return jnp.sum(out * cot)

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss, argnums=(0, 1, 2, 3))(a, b, w2, b2)
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _grads_port(inp, cot, aggr, slope, mean, dtype=None):
    """``torch.autograd`` of the same loss through the port's
    ``fused_edgeconv`` Function on the CPU (plain forward and backward)."""
    leaves = [
        torch.from_numpy(inp[n]).to(dtype or torch.float32).requires_grad_()
        for n in ("a", "b", "w2", "b2")
    ]
    a, b, w2, b2 = leaves
    idx, em = torch.from_numpy(inp["idx"]), torch.from_numpy(inp["em"])
    out = fused_edgeconv(a, b, idx, em, w2, b2, aggr=aggr, slope=slope)
    if mean:
        out = out / em.sum(dim=2, keepdim=True).clamp_min(1)
    (out * torch.from_numpy(cot)).sum().backward()
    for t in leaves:
        assert t.grad.dtype == t.dtype
    return [t.grad.float().numpy() for t in leaves]


# (aggr, slope, mean, H1, H2, k): the layer shapes of the first cases,
# then widths that are no multiple of 16 (the CUDA kernel's tiles pad
# them) and k = 1 and 3
@pytest.mark.parametrize(
    "aggr,slope,mean,H1,H2,k",
    [
        ("add", 0.0, False, 16, 8, 4),
        ("max", 0.01, False, 16, 8, 4),
        ("add", 0.0, True, 16, 8, 4),
        ("add", 0.0, False, 20, 12, 1),
        ("max", 0.01, False, 20, 12, 3),
        ("add", 0.0, True, 36, 10, 3),
        ("max", 0.0, False, 12, 20, 1),
    ],
    ids=["add_relu", "max_leaky", "mean_relu", "add_relu-H1_20-H2_12-k1",
         "max_leaky-H1_20-H2_12-k3", "mean_relu-H1_36-H2_10-k3",
         "max_relu-H1_12-H2_20-k1"],
)
def test_fused_edgeconv_grads_match_pallas(aggr, slope, mean, H1, H2, k):
    inp = _edge_inputs(seed=41, H1=H1, H2=H2, k=k)
    inp["em"][1, 7] = False  # a node with no valid edge
    cot = np.random.default_rng(42).standard_normal((2, 32, H2)).astype(np.float32)
    got = _grads_port(inp, cot, aggr, slope, mean)
    exp = _grads_jax(inp, cot, aggr, slope, mean)
    for name, g, e in zip(("da", "db", "dw2", "db2"), got, exp):
        np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[0][1, 7], 0.0)


def test_fused_edgeconv_grads_bf16_match_pallas():
    inp = _edge_inputs(seed=43)
    cot = np.random.default_rng(44).standard_normal((2, 32, 8)).astype(np.float32)
    got = _grads_port(inp, cot, "add", 0.0, False, torch.bfloat16)
    exp = _grads_jax(inp, cot, "add", 0.0, False, jnp.bfloat16)
    for name, g, e in zip(("da", "db", "dw2", "db2"), got, exp):
        # the same bf16 operands and rounding points with fp32 sums; the
        # results themselves are rounded to bf16 on both sides
        err = np.abs(g - e).max() / np.abs(e).max()
        assert err <= 2e-2, f"{name}: {err} of the max"


def test_fused_edgeconv_grads_bf16_max_match_pallas():
    """bf16 with max aggregation: the first-argmax routing on pre2 from
    bf16 messages and weights, both sides at the same tolerance as add."""
    inp = _edge_inputs(seed=48)
    inp["em"][0, 5] = False  # a node with no valid edge
    cot = np.random.default_rng(49).standard_normal((2, 32, 8)).astype(np.float32)
    got = _grads_port(inp, cot, "max", 0.01, False, torch.bfloat16)
    exp = _grads_jax(inp, cot, "max", 0.01, False, jnp.bfloat16)
    for name, g, e in zip(("da", "db", "dw2", "db2"), got, exp):
        err = np.abs(g - e).max() / np.abs(e).max()
        assert err <= 2e-2, f"{name}: {err} of the max"
    np.testing.assert_array_equal(got[0][0, 5], 0.0)


def test_fused_edgeconv_max_tie_routes_to_first_edge():
    """Two valid edges of a node to the same neighbour give identical
    messages, an exact tie in every channel: the gradient goes to the
    lower kk only, as in the Pallas kernel, so masking the second edge
    changes no gradient."""
    inp = _edge_inputs(seed=45)
    inp["idx"][0, :, 2] = inp["idx"][0, :, 1]
    inp["em"][0, :, 1:3] = True
    cot = np.random.default_rng(46).standard_normal((2, 32, 8)).astype(np.float32)
    got = _grads_port(inp, cot, "max", 0.01, False)
    exp = _grads_jax(inp, cot, "max", 0.01, False)
    untied = dict(inp, em=inp["em"].copy())
    untied["em"][0, :, 2] = False
    alone = _grads_port(untied, cot, "max", 0.01, False)
    for name, g, e, u in zip(("da", "db", "dw2", "db2"), got, exp, alone):
        np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g, u, rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_edgeconv_bwd_scratch_plan(dtype):
    """The CUDA backward's scratch at DynEdge's training shape (B=128,
    L=128, k=8, H1=336, H2=256): W2^T, the gm rows padded to the kernel's
    column chunk and the g_z rows in the compute dtype, fp32 partials and
    the flags of the dW2 slices that hold a valid edge, int32 reverse
    index; under the ~0.5 GB of the nine-launch design (msgs, gm and g_z
    rows in fp32), and each dW2 slice at most 1024 rows.  fp32 takes the
    128-row edge kernel: a db2 partial per two of the forward's blocks."""
    from graphnet_tpu_torch.ops.edgeconv_cuda import bwd_scratch_plan

    plan = bwd_scratch_plan(128, 128, 336, 256, 8, dtype)
    E, H2p = 128 * 128 * 8, 256
    pairs = dtype == torch.float32  # the 128-row edge kernel
    assert list(plan) == ["w2t", "gm", "gz", "dw2_part", "dw2_used",
                          "db2_part", "offs", "list"]
    assert plan["w2t"] == ((256, 336), dtype)
    assert plan["gm"] == ((E, H2p), dtype)
    assert plan["gz"] == ((E, 336), dtype)
    assert plan["dw2_part"] == ((128, 336, 256), torch.float32)
    assert plan["dw2_used"] == ((128,), torch.int32)
    assert plan["db2_part"] == ((128 * (8 if pairs else 16), 256),
                                torch.float32)
    assert plan["offs"] == ((128, 129), torch.int32)
    assert plan["list"] == ((128, 1024), torch.int32)
    total = sum(np.prod(shape) * dt.itemsize for shape, dt in plan.values())
    old = 4 * E * (336 + 256 + 336) + 4 * 128 * 336 * 256
    assert total < old
    # widths that are no multiple of the column chunk are padded (128 in
    # bf16, 256 in fp32); every slice of the edge rows holds <= 1024 rows
    chunk = 128 if dtype == torch.bfloat16 else 256
    odd = bwd_scratch_plan(3, 100, 104, 72, 12, dtype)
    assert odd["gm"] == ((3 * 100 * 12, chunk), dtype)
    assert odd["db2_part"][0] == (3 * (10 if pairs else 20), 72)
    n_slices = odd["dw2_part"][0][0]
    assert -(-3 * 100 * 12 // n_slices) <= 1024
    assert odd["dw2_used"][0] == (n_slices,)


@pytest.mark.parametrize("k", [1, 8, 12, 32, 64])
def test_fused_edgeconv_bwd_route(k):
    """The backward's route from (H1, H2, k, dtype): QUESO's four layer
    shapes (conv 0 at (128, 256), convs 1-3 at (336, 256)) take the
    128-row fp32 edge kernel at every k, whose shared memory the wrapper
    counts as the kernel's layout does (218,000 bytes at H1 = 336); bf16
    keeps the tensor-core kernel; widths past the 128-row kernel's (H1
    past 352, H2 past 256) take the 64-row fp32 kernel."""
    from graphnet_tpu_torch.ops.edgeconv_cuda import (
        HOPPER_SMEM_OPTIN,
        _rows128_smem,
        bwd_route,
    )

    f32, b16 = torch.float32, torch.bfloat16
    for h1, h2 in ((128, 256), (336, 256), (336, 256), (336, 256)):
        assert bwd_route(h1, h2, k, f32) == "fp32_rows128"
        assert bwd_route(h1, h2, k, b16) == "bf16"
    assert (_rows128_smem(128), _rows128_smem(336)) == (206480, 218000)
    # widths that are no multiple of 8 are routed as the kernels take them
    assert bwd_route(100, 72, k, f32) == "fp32_rows128"
    assert bwd_route(352, 256, k, f32) == "fp32_rows128"
    assert _rows128_smem(352) <= HOPPER_SMEM_OPTIN < _rows128_smem(360)
    assert bwd_route(360, 256, k, f32) == "fp32_rows64"
    assert bwd_route(336, 264, k, f32) == "fp32_rows64"
    assert bwd_route(512, 512, k, b16) == "bf16"
    with pytest.raises(ValueError, match="k="):
        bwd_route(336, 256, 65, f32)


def test_fused_edgeconv_bwd_checks_inputs_and_counts_nothing_on_cpu():
    from graphnet_tpu_torch.ops.edgeconv_cuda import (
        fused_edgeconv_bwd,
        fused_edgeconv_bwd_plain,
    )

    t = {k: torch.from_numpy(v) for k, v in _edge_inputs(seed=47).items()}
    # a strided slice, as a skip-concat hands the conv's output gradient
    g = torch.randn(2, 32, 16, generator=torch.Generator().manual_seed(0))
    g = g[..., ::2]
    before = fused_edgeconv_bwd.launches
    got = fused_edgeconv_bwd(*t.values(), g)
    exp = fused_edgeconv_bwd_plain(*t.values(), g)
    assert fused_edgeconv_bwd.launches == before  # the plain version ran
    for x, y in zip(got, exp):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    with pytest.raises(ValueError, match="g must be"):
        fused_edgeconv_bwd(*t.values(), g[:, :, :4])
    with pytest.raises(ValueError):
        fused_edgeconv_bwd(*t.values(), g, aggr="mean")
