"""The port's fused EdgeConv + kNN (``fused_edgeconv_knn``) against the
JAX package on the CPU: its plain version against the JAX op in Pallas
interpret mode, its gradients against ``jax.grad`` of the JAX op, its
gate in ``EdgeConv``, and a narrow DynEdge with ``FUSE_CONV_KNN`` on
against the JAX DynEdge."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    EnergyReconstruction as JaxEnergy,
)
from graphnet_tpu.ops.edgeconv_pallas import (
    fused_edgeconv_knn as jax_fused_knn,
)
from graphnet_tpu.training import loss_functions as jlf
from graphnet_tpu.utils.config import TRANSFORM_REGISTRY
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.models.components import layers
from graphnet_tpu_torch.models.components.layers import EdgeConv
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
from graphnet_tpu_torch.ops import edgeconv_cuda, knn_cuda
from graphnet_tpu_torch.ops.edgeconv_cuda import (
    fused_edgeconv_knn,
    fused_edgeconv_knn_plain,
    fused_edgeconv_plain,
)
from graphnet_tpu_torch.ops.knn import knn_graph_plain
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(2)

H1, H2, K, KNN_K = 16, 8, 4, 4


def _inputs(L, seed, B=3, H1=H1, H2=H2):
    """Conv inputs over ``B`` events of length ``L``: event 0 ragged,
    event 1 with one valid node, event 2 with ``KNN_K - 1`` (fewer than
    ``knn_k + 1``); edges only between valid nodes, as a kNN gives."""
    rng = np.random.default_rng(seed)
    n = np.array([int(rng.integers(L // 2, L + 1)), 1, KNN_K - 1])[:B]
    mask = np.arange(L)[None, :] < n[:, None]
    idx = rng.integers(0, L, (B, L, K)).astype(np.int32)
    em = (rng.random((B, L, K)) > 0.2) & mask[:, :, None]
    em &= np.take_along_axis(np.broadcast_to(mask[:, None, :], (B, L, L)), idx, 2)
    return dict(
        a=rng.standard_normal((B, L, H1)).astype(np.float32),
        b=rng.standard_normal((B, L, H1)).astype(np.float32),
        idx=idx,
        em=em,
        mask=mask,
        w2=rng.standard_normal((H1, H2)).astype(np.float32),
        b2=rng.standard_normal((H2,)).astype(np.float32),
    )


_CAST = ("a", "b", "w2", "b2")  # cast to bf16 in the bf16 mode


def _jax(inp, aggr, slope, lo=0, hi=3, bf16=False):
    with pltpu.force_tpu_interpret_mode():
        out, nidx, nem = jax_fused_knn(
            *(jnp.asarray(v).astype(jnp.bfloat16) if bf16 and n in _CAST
              else jnp.asarray(v) for n, v in inp.items()),
            aggr, slope, KNN_K, lo, hi
        )
    return np.asarray(out), np.asarray(nidx), np.asarray(nem)


def _port(inp, aggr, slope, lo=0, hi=3, bf16=False):
    out, nidx, nem = fused_edgeconv_knn(
        *(torch.from_numpy(v).to(torch.bfloat16) if bf16 and n in _CAST
          else torch.from_numpy(v) for n, v in inp.items()),
        aggr=aggr, slope=slope, knn_k=KNN_K, sub_lo=lo, sub_hi=hi,
    )
    return out.detach().numpy(), nidx.numpy(), nem.numpy()


def _assert_same_neighbours(coords, mask, i_exp, m_exp, i_got, m_got):
    """The edge masks equal; the neighbours equal wherever the mask holds,
    but for near-ties: the two sides centre in another order (the JAX
    kernel in fp32, the port's in float64 in index order), so a pair of
    keys within 1e-5 relative of each other's distance may swap."""
    np.testing.assert_array_equal(m_got, m_exp)
    c = coords.astype(np.float64)
    for e, q, j in zip(*np.nonzero(m_exp & (i_exp != i_got))):
        d = lambda i: ((c[e, i] - c[e, q]) ** 2).sum()  # noqa: E731
        da, db = d(i_exp[e, q, j]), d(i_got[e, q, j])
        assert abs(da - db) <= 1e-5 * max(da, db), (e, q, j, da, db)
    assert mask.shape == m_exp.shape[:2]


@pytest.mark.parametrize("L", [32, 48])
@pytest.mark.parametrize(
    "aggr,slope", [("add", 0.0), ("max", 0.01), ("add", 0.01), ("max", 0.0)]
)
def test_fused_knn_plain_matches_pallas(aggr, slope, L):
    """The conv output within 1e-5 (only the summation order differs),
    the adjacency equal up to near-ties; the 1-node event has no edge and
    the event of ``knn_k - 1`` nodes ``knn_k - 2`` edges a node."""
    inp = _inputs(L, seed=L + int(slope * 100) + (aggr == "max"))
    out_j, idx_j, em_j = _jax(inp, aggr, slope)
    out, idx, em = _port(inp, aggr, slope)
    assert out.dtype == np.float32 and idx.dtype == np.int32 and em.dtype == bool
    np.testing.assert_allclose(out, out_j, rtol=1e-5, atol=1e-5)
    _assert_same_neighbours(out[..., :3], inp["mask"], idx_j, em_j, idx, em)
    assert not em[1].any()
    assert (em[2].sum(-1) == np.where(inp["mask"][2], KNN_K - 2, 0)).all()
    assert not em[~inp["mask"]].any()


def test_fused_knn_on_columns_1_to_5_matches_pallas():
    """Four columns from an offset (TITO-like x, y, z, t)."""
    inp = _inputs(32, seed=7)
    out_j, idx_j, em_j = _jax(inp, "add", 0.0, 1, 5)
    out, idx, em = _port(inp, "add", 0.0, 1, 5)
    np.testing.assert_allclose(out, out_j, rtol=1e-5, atol=1e-5)
    _assert_same_neighbours(out[..., 1:5], inp["mask"], idx_j, em_j, idx, em)


@pytest.mark.parametrize(
    "h1,h2,bf16,aggr,slope",
    [(20, 12, False, "max", 0.01), (36, 10, False, "add", 0.0),
     (20, 12, True, "max", 0.01), (16, 8, True, "add", 0.0)],
    ids=["H1_20-H2_12-max", "H1_36-H2_10-add", "bf16-H1_20-H2_12-max",
         "bf16-add"],
)
def test_fused_knn_plain_matches_pallas_at_other_widths(h1, h2, bf16, aggr,
                                                        slope):
    """Widths that are no multiple of 16 (the CUDA wrapper pads them to
    multiples of 8) and bf16 operands (fp32 sums on both sides): the
    conv output within 1e-5 (fp32) or 1e-4 (bf16), the adjacency equal
    up to near-ties."""
    inp = _inputs(48, seed=h1 + h2, H1=h1, H2=h2)
    out_j, idx_j, em_j = _jax(inp, aggr, slope, bf16=bf16)
    out, idx, em = _port(inp, aggr, slope, bf16=bf16)
    tol = 1e-4 if bf16 else 1e-5
    np.testing.assert_allclose(out, out_j, rtol=tol, atol=tol)
    _assert_same_neighbours(out[..., :3], inp["mask"], idx_j, em_j, idx, em)
    assert not em[1].any() and not em[~inp["mask"]].any()


def test_fused_knn_plain_is_the_conv_then_the_knn():
    """The plain version is the plain conv, bit for bit, then the kNN of
    its output: the graph of ``knn_graph_plain`` (which centres by the
    same float64 rule), bit for bit."""
    inp = _inputs(48, seed=3)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    args = (t["a"], t["b"], t["idx"], t["em"])
    out, idx, em = fused_edgeconv_knn_plain(
        *args, t["mask"], t["w2"], t["b2"], "max", 0.01, KNN_K, 0, 3)
    conv = fused_edgeconv_plain(*args, t["w2"], t["b2"], "max", 0.01)
    assert torch.equal(out, conv)
    ref_i, ref_m = knn_graph_plain(conv[..., :3], t["mask"], KNN_K)
    assert torch.equal(em, ref_m)
    assert torch.equal(torch.where(em, idx, -1), torch.where(ref_m, ref_i, -1))


@pytest.mark.parametrize("aggr,slope", [("add", 0.0), ("max", 0.01)])
def test_fused_knn_grads_match_jax(aggr, slope):
    """``sum(out * cot)`` through the port's Function (its backward is the
    EdgeConv backward) against ``jax.grad`` of the JAX op, within 1e-5."""
    inp = _inputs(32, seed=11)
    cot = np.random.default_rng(12).standard_normal((3, 32, H2)).astype(np.float32)
    names = ("a", "b", "w2", "b2")

    def loss(a, b, w2, b2):
        out = jax_fused_knn(a, b, jnp.asarray(inp["idx"]), jnp.asarray(inp["em"]),
                            jnp.asarray(inp["mask"]), w2, b2, aggr, slope,
                            KNN_K, 0, 3)[0]
        return jnp.sum(out * cot)

    with pltpu.force_tpu_interpret_mode():
        exp = jax.grad(loss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(inp[n]) for n in names))
    leaves = {n: torch.from_numpy(inp[n]).requires_grad_() for n in names}
    out, nidx, nem = fused_edgeconv_knn(
        leaves["a"], leaves["b"], torch.from_numpy(inp["idx"]),
        torch.from_numpy(inp["em"]), torch.from_numpy(inp["mask"]),
        leaves["w2"], leaves["b2"], aggr=aggr, slope=slope, knn_k=KNN_K)
    assert not nidx.requires_grad and not nem.requires_grad
    (out * torch.from_numpy(cot)).sum().backward()
    for n, e in zip(names, exp):
        np.testing.assert_allclose(leaves[n].grad.numpy(), np.asarray(e),
                                   rtol=1e-5, atol=1e-5, err_msg=n)


def test_fused_knn_checks_inputs_and_counts_nothing_on_cpu():
    t = {k: torch.from_numpy(v) for k, v in _inputs(32, seed=13).items()}
    before = fused_edgeconv_knn.launches
    fused_edgeconv_knn(*t.values(), knn_k=KNN_K)
    assert fused_edgeconv_knn.launches == before
    with pytest.raises(ValueError, match="nmask"):
        fused_edgeconv_knn(*(v if k != "mask" else v[:, :8]
                             for k, v in t.items()))
    with pytest.raises(ValueError, match="columns"):
        fused_edgeconv_knn(*t.values(), sub_lo=6, sub_hi=9)
    with pytest.raises(ValueError, match="knn_k"):
        fused_edgeconv_knn(*t.values(), knn_k=33)
    with pytest.raises(ValueError, match="aggr"):
        fused_edgeconv_knn(*t.values(), aggr="mean")


def test_edgeconv_gate(monkeypatch):
    """The JAX gate: the switch, a kNN width and subset, a node mask, add
    or max, L <= 128 and the kernel route (a two-layer relu MLP)."""
    conv = EdgeConv(4, (16, 8), aggr="add", knn_k=4, knn_subset=(0, 3))
    mask = torch.ones(2, 128, dtype=torch.bool)
    assert not conv.uses_fused_knn(128, mask)  # the switch is off
    monkeypatch.setattr(layers, "FUSE_CONV_KNN", True)
    assert conv.uses_fused_knn(128, mask)
    assert not conv.uses_fused_knn(129, mask)
    assert not conv.uses_fused_knn(128, None)
    assert not EdgeConv(4, (16, 8), aggr="mean", knn_k=4,
                        knn_subset=(0, 3)).uses_fused_knn(64, mask)
    assert not EdgeConv(4, (16, 8), activation="gelu", knn_k=4,
                        knn_subset=(0, 3)).uses_fused_knn(64, mask)
    assert not EdgeConv(4, (16, 8)).uses_fused_knn(64, mask)
    # the kernel's limits: at most 16 neighbours, on 3 or 4 columns
    assert not EdgeConv(4, (16, 8), knn_k=17,
                        knn_subset=(0, 3)).uses_fused_knn(64, mask)
    assert not EdgeConv(4, (16, 8), knn_k=4,
                        knn_subset=(0, 2)).uses_fused_knn(64, mask)
    # a subset that is not contiguous keeps the standalone kNN
    model = DynEdge(nb_inputs=4, features_subset=(0, 2, 3))
    assert model.conv_0.conv.knn_subset is None
    assert DynEdge(nb_inputs=4).conv_0.conv.knn_subset == (0, 3)


NARROW = dict(
    dynedge_layer_sizes=((16, 32), (24, 32)),
    post_processing_layer_sizes=(24, 16),
    readout_layer_sizes=(8,),
)


def test_dynedge_with_the_switch_on_matches_jax(monkeypatch):
    """A narrow DynEdge with ``FUSE_CONV_KNN`` on: every conv goes through
    the fused op (1 standalone kNN, 2 fused calls, no other conv call),
    and the latents, predictions, loss and every gradient match the JAX
    DynEdge (rtol 2e-4, an absolute floor of 2e-5 of each gradient's
    max, as ``tests/test_torch_training.py``)."""
    rng = np.random.default_rng(21)
    events = [(rng.standard_normal((int(n), 4)) * [50, 50, 50, 5]).astype(np.float32)
              for n in (30, 6, 1, 17)]
    labels = {"total_energy": np.array([10.0, 300.0, 50.0, 2.0], np.float32)}
    jb = jax_make_batch(events, labels=labels, length=32)
    tb = make_batch(events, labels=labels, length=32)
    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4, **NARROW),
        tasks=(JaxEnergy(loss_function=jlf.LogCoshLoss(),
                         target_labels=("total_energy",),
                         transform_prediction_and_target=TRANSFORM_REGISTRY["log10"]),),
    )
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3), jb))

    def loss_fn(p):
        outs = jmodel.apply(p, jb)
        return jmodel.loss_from_batch(outs, jb), outs[0][0]

    (j_loss, j_pred), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = StandardModel(
        DynEdge(nb_inputs=4, **NARROW),
        [EnergyReconstruction(hidden_size=8, loss_function=tlf.LogCoshLoss(),
                              target_labels=("total_energy",),
                              transform_prediction_and_target=torch.log10)],
        device="cpu",
    )
    model.load_state_dict(params_from_jax(params, model.state_dict()))

    calls = {"fused": 0, "conv": 0, "knn": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(layers, "FUSE_CONV_KNN", True)
    monkeypatch.setattr(edgeconv_cuda, "fused_edgeconv_knn_plain",
                        counting("fused", fused_edgeconv_knn_plain))
    monkeypatch.setattr(layers, "fused_edgeconv",
                        counting("conv", layers.fused_edgeconv))
    monkeypatch.setattr(knn_cuda, "knn_graph_plain",
                        counting("knn", knn_cuda.knn_graph_plain))
    outs = model(tb)
    assert calls == {"fused": 2, "conv": 0, "knn": 1}
    loss = model.loss_from_batch(outs, tb)
    loss.backward()
    np.testing.assert_allclose(outs[0][0].detach().numpy(), np.asarray(j_pred),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=2e-4)
    exp = params_from_jax(jax.device_get(j_grads), model.state_dict())
    for name, p in model.named_parameters():
        e = exp[name].numpy()
        assert p.grad is not None and np.abs(e).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), e, rtol=2e-4,
                                   atol=2e-5 * np.abs(e).max(), err_msg=name)
