"""The port's edge rules and graph utilities against the JAX package on
the CPU: ``radius_graph`` (the kNN at k = 32, then the radius),
``minkowski_knn_graph``, the four rules' ``build``, ``EuclideanEdges``'
affinity order, ``knn_graph_batch`` and ``calculate_*``, the rules'
configs, and a StandardModel that evaluates ``RadialEdges`` or
``EuclideanEdges`` before its DynEdge (rtol 2e-4).

The graphs must be the same indices and edge masks bit for bit.  The two
packages compute distances in other orders of float32 operations, so
the random inputs are checked (``_tie_free``) to hold no two distances,
and no distance and ``r^2``, within 1e-6 of each other where the choice
depends on them; the integer grids hold exact ties, where only the
lower-index rule decides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import graphnet_tpu.models.graphs.edges as jedges
import graphnet_tpu.utils.config as jconfig
from graphnet_tpu import ops as jops
from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.models import utils as jutils
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import EnergyReconstruction as JaxEnergy
from graphnet_tpu.training import loss_functions as jlf
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.models import utils as tutils
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.graphs import edges as tedges
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
from graphnet_tpu_torch.ops import knn as tknn
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.utils import config
from graphnet_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(2)

NARROW = dict(
    dynedge_layer_sizes=((16, 32), (24, 32)),
    post_processing_layer_sizes=(24, 16),
    readout_layer_sizes=(8,),
)


def _ragged(seed, B, L, D=4, lo=None, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, L, D)) * scale).astype(np.float32)
    n = rng.integers(lo or L // 2, L + 1, B)
    mask = np.arange(L)[None] < n[:, None]
    return np.where(mask[..., None], x, 0.0).astype(np.float32), mask


def _tie_free(d2, mask, k, r2=None, rel=1e-6):
    """Assert that the float64 ``d2 [B, L, L]`` of each valid query over
    its valid other nodes has no two of its k + 1 smallest within
    ``rel`` of each other, and (with ``r2``) none within ``rel`` of
    ``r2``."""
    B, L, _ = d2.shape
    for b in range(B):
        for i in np.flatnonzero(mask[b]):
            row = np.sort(np.delete(d2[b, i], i)[np.delete(mask[b], i)])[:k + 1]
            scale = max(np.abs(row).max(), 1e-30)
            assert (np.diff(row) > rel * scale).all(), (b, i, row)
            if r2 is not None:
                assert (np.abs(row[:k] - r2) > rel * r2).all(), (b, i)


def _d2(x):
    x = x.astype(np.float64)
    return ((x[:, :, None] - x[:, None]) ** 2).sum(-1)


def _same_graph(got, exp):
    gi, gm = (t.numpy() for t in got)
    ei, em = (np.asarray(t) for t in exp)
    np.testing.assert_array_equal(gm, em)
    np.testing.assert_array_equal(np.where(gm, gi, 0), np.where(em, ei, 0))


def _grid(seed, with_time=False):
    """Two events of integer grid points in shuffled order (a 4 x 4 x 4
    cube and a 2 x 2 x 4 slab, L=64), times integers too."""
    rng = np.random.default_rng(seed)
    g4 = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
    g2 = np.stack(np.meshgrid(np.arange(2), np.arange(2), np.arange(4),
                              indexing="ij"), -1)
    x = np.zeros((2, 64, 4), np.float32)
    x[0, :, :3] = rng.permutation(g4.reshape(-1, 3))
    x[1, :16, :3] = rng.permutation(g2.reshape(-1, 3))
    if with_time:
        x[0, :, 3] = rng.integers(0, 3, 64)
        x[1, :16, 3] = rng.integers(0, 3, 16)
    mask = np.arange(64)[None] < np.array([64, 16])[:, None]
    return x, mask


# ------------------------------------------------------------- the ops
@pytest.mark.parametrize("k", [8, 32])
def test_radius_graph_matches_jax(k):
    x, mask = _ragged(1, 4, 48, D=3, lo=36)
    r = 1.3
    _tie_free(_d2(x), mask, k, r2=r * r)
    got = tknn.radius_graph(torch.from_numpy(x), torch.from_numpy(mask), r, k)
    exp = jops.radius_graph(jnp.asarray(x), jnp.asarray(mask), r=r, k=k)
    _same_graph(got, exp)
    # some pairs inside and some beyond r, on events of fewer than k + 1
    em = got[1].numpy()
    assert 0 < em.sum() < (mask.sum(1) * k).sum()


def test_chosen_sq_dists_are_the_matrix_entries():
    """The radius is tested on the chosen pairs' distances, which equal
    ``pairwise_sq_dists``' entries bit for bit."""
    x, mask = _ragged(2, 3, 40, D=3)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    idx, em = tknn.knn_graph(xt, mt, 32)
    full = tknn.pairwise_sq_dists(xt, mt)
    exp = torch.gather(full, 2, idx.long())
    got = tknn.chosen_sq_dists(xt, mt, idx)
    assert torch.equal(torch.where(em, got, 0.0), torch.where(em, exp, 0.0))


def test_knn_at_k32_matches_jax():
    """The kNN at the radius graph's k = 32 (row 1's new range) against
    the JAX kNN, and D=4."""
    for D in (3, 4):
        x, mask = _ragged(3 + D, 4, 40, D=D, lo=34)
        _tie_free(_d2(x), mask, 32)
        got = tknn.knn_graph(torch.from_numpy(x), torch.from_numpy(mask), 32)
        _same_graph(got, jops.knn_graph(jnp.asarray(x), jnp.asarray(mask), 32))


def test_minkowski_matches_jax():
    x, mask = _ragged(5, 4, 24, lo=12)
    c = 0.299792458
    t = x[..., 3].astype(np.float64) * c
    interval = _d2(x[..., :3]) - (t[:, :, None] - t[:, None]) ** 2
    _tie_free(interval, mask, 8)
    got = tknn.minkowski_knn_graph(torch.from_numpy(x), torch.from_numpy(mask), 8)
    _same_graph(got, jops.minkowski_knn_graph(jnp.asarray(x), jnp.asarray(mask), 8))


def test_minkowski_ties_go_to_the_lower_index():
    """Integer grids with integer times and c = 1: every interval is
    exact, many tie (and many are negative)."""
    x, mask = _grid(6, with_time=True)
    for k in (8, 16):
        got = tknn.minkowski_knn_graph(torch.from_numpy(x), torch.from_numpy(mask),
                                       k, c=1.0)
        _same_graph(got, jops.minkowski_knn_graph(jnp.asarray(x), jnp.asarray(mask),
                                                  k, c=1.0))


# ------------------------------------------------------------ the rules
def _rule_pairs():
    return [
        ("knn", jedges.KNNEdges(), tedges.KNNEdges()),
        ("radial", jedges.RadialEdges(radius=1.3), tedges.RadialEdges(radius=1.3)),
        ("minkowski", jedges.MinkowskiKNNEdges(), tedges.MinkowskiKNNEdges()),
        ("euclidean", jedges.EuclideanEdges(sigma=0.7, threshold=1e-3,
                                            max_neighbours=12),
         tedges.EuclideanEdges(sigma=0.7, threshold=1e-3, max_neighbours=12)),
    ]


@pytest.mark.parametrize("name,jrule,trule", _rule_pairs(),
                         ids=[p[0] for p in _rule_pairs()])
def test_rule_build_matches_jax(name, jrule, trule):
    x, mask = _ragged(9, 4, 40, lo=34)  # a seed _tie_free accepts
    xyz = x[..., :3]
    if name == "minkowski":
        t = x[..., 3].astype(np.float64) * jrule.c
        _tie_free(_d2(xyz) - (t[:, :, None] - t[:, None]) ** 2, mask, 8)
    else:
        k = getattr(trule, "max_neighbours", 8)
        _tie_free(_d2(xyz), mask, k,
                  r2=trule.radius ** 2 if name == "radial" else None)
    got = trule.build(torch.from_numpy(x), torch.from_numpy(mask))
    _same_graph(got, jrule.build(jnp.asarray(x), jnp.asarray(mask)))
    assert config.capture_config(trule).as_dict() == jconfig.capture_config(
        jrule).as_dict()


def test_euclidean_ties_go_to_the_lower_index():
    """On the integer grids (centre exact) equal distances give equal
    normalised affinities: the stable descending sort keeps the lower
    index first, as ``top_k``."""
    x, mask = _grid(8)
    for kw in (dict(sigma=1.0, max_neighbours=12),
               dict(sigma=2.0, threshold=0.02, max_neighbours=20)):
        got = tedges.EuclideanEdges(**kw).build(torch.from_numpy(x),
                                               torch.from_numpy(mask))
        exp = jedges.EuclideanEdges(**kw).build(jnp.asarray(x), jnp.asarray(mask))
        _same_graph(got, exp)


def test_rule_in_a_graph_definition_dumps_the_jax_config(tmp_path):
    """A graph definition naming each rule: the port builds the file and
    dumps what the JAX package dumps."""
    from graphnet_tpu.models.detector.prometheus import Prometheus as JaxPrometheus
    from graphnet_tpu.models.graphs.graph_definition import (
        GraphDefinition as JaxGraphDefinition,
    )

    for _, jrule, _ in _rule_pairs():
        gd = JaxGraphDefinition(detector=JaxPrometheus(), edge_definition=jrule)
        path = tmp_path / "gd.yml"
        jconfig.save_model_config(gd, str(path))
        built = config.load_model(str(path), device="cpu")
        assert type(built.edge_definition).__name__ == type(jrule).__name__
        again = tmp_path / "port.yml"
        config.save_model_config(built, str(again))
        assert again.read_text() == path.read_text()


# ------------------------------------------------------- models/utils
def test_knn_graph_batch_matches_jax():
    x, mask = _ragged(9, 4, 32, D=3, lo=20)
    _tie_free(_d2(x), mask, 12)
    for k in (5, [3, 12, 1, 7]):
        got = tutils.knn_graph_batch(torch.from_numpy(x), torch.from_numpy(mask), k)
        exp = jutils.knn_graph_batch(jnp.asarray(x), jnp.asarray(mask), k)
        _same_graph(got, exp)
    with pytest.raises(ValueError, match="one per event"):
        tutils.knn_graph_batch(torch.from_numpy(x), torch.from_numpy(mask), [3, 4])


def test_distance_matrix_and_homophily_match_jax():
    x, mask = _ragged(10, 3, 20, D=5, lo=10)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        tutils.calculate_distance_matrix(xt[..., :3]).numpy(),
        np.asarray(jutils.calculate_distance_matrix(jnp.asarray(x[..., :3]))),
        rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(
        tutils.calculate_distance_matrix(xt[0, :, :3]).numpy(),
        np.asarray(jutils.calculate_distance_matrix(jnp.asarray(x[0, :, :3]))),
        rtol=2e-6, atol=1e-6)
    idx, em = tknn.knn_graph(xt[..., :3], torch.from_numpy(mask), 4)
    got = tutils.calculate_xyzt_homophily(xt, idx, em)
    exp = jutils.calculate_xyzt_homophily(jnp.asarray(x), jnp.asarray(idx.numpy()),
                                          jnp.asarray(em.numpy()))
    for g, e in zip(got, exp):
        assert g.shape == (3, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=2e-6, atol=1e-7)


def test_array_to_sequence_and_get_fields_match_jax():
    from graphnet_tpu.models.graphs.graph_definition import Event as JaxEvent
    from graphnet_tpu_torch.models.graphs.graph_definition import Event

    rng = np.random.default_rng(11)
    rows = rng.standard_normal((13, 3)).astype(np.float32)
    batch_idx = np.array([0] * 4 + [2] * 6 + [5] * 3)
    for got, exp in zip(tutils.array_to_sequence(rows, batch_idx, -1.0),
                        jutils.array_to_sequence(rows, batch_idx, -1.0)):
        np.testing.assert_array_equal(got, exp)
    with pytest.raises(ValueError, match="non-decreasing"):
        tutils.array_to_sequence(rows, batch_idx[::-1])
    labels = [{"energy": np.float32(i + 1.5), "zenith": np.float32(0.1 * i)}
              for i in range(3)]
    t_events = [Event(x=rows[:2], features=["a", "b", "c"], labels=l)
                for l in labels]
    j_events = [JaxEvent(x=rows[:2], features=["a", "b", "c"], labels=l)
                for l in labels]
    np.testing.assert_array_equal(
        tutils.get_fields(t_events, ["energy", "zenith", "n_pulses"]),
        jutils.get_fields(j_events, ["energy", "zenith", "n_pulses"]))
    np.testing.assert_array_equal(tutils.get_fields(labels[0], ["energy"]),
                                  jutils.get_fields(labels[0], ["energy"]))


# -------------------------------------------- a model with a rule first
@pytest.mark.parametrize("rule", ["radial", "euclidean"])
def test_model_with_an_edge_rule_matches_jax(rule):
    """DynEdge after ``RadialEdges`` (its kNN at k = 32) or
    ``EuclideanEdges``: predictions, loss and gradients against the JAX
    StandardModel with the same rule, from the same parameters."""
    rng = np.random.default_rng(12)
    events = [(rng.standard_normal((int(n), 4)) * [1, 1, 1, 5]).astype(np.float32)
              for n in rng.integers(34, 48, 4)]
    labels = {"total_energy": rng.uniform(10, 1000, 4).astype(np.float32)}
    jb = jax_make_batch(events, labels=labels, length=48)
    tb = make_batch(events, labels=labels, length=48)
    x, mask = tb.x.numpy(), tb.mask.numpy()
    if rule == "radial":
        jrule, trule = jedges.RadialEdges(radius=1.5), tedges.RadialEdges(radius=1.5)
        _tie_free(_d2(x[..., :3]), mask, 32, r2=2.25)
    else:
        jrule = jedges.EuclideanEdges(sigma=0.8, threshold=1e-4, max_neighbours=16)
        trule = tedges.EuclideanEdges(sigma=0.8, threshold=1e-4, max_neighbours=16)
        _tie_free(_d2(x[..., :3]), mask, 16)
    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4, **NARROW),
        tasks=(JaxEnergy(loss_function=jlf.LogCoshLoss(),
                         target_labels=("total_energy",)),),
        edge_definition=jrule)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(4), jb))
    model = StandardModel(
        DynEdge(nb_inputs=4, **NARROW),
        [EnergyReconstruction(hidden_size=8, loss_function=tlf.LogCoshLoss(),
                              target_labels=("total_energy",))],
        edge_definition=trule, device="cpu")
    model.load_state_dict(params_from_jax(params, model.state_dict()))

    def jloss(p):
        return jmodel.loss_from_batch(jmodel.apply(p, jb), jb)

    val_j, grad_j = jax.value_and_grad(jloss)(params)
    pred_j = np.asarray(jmodel.apply(params, jb)[0][0])
    out = model(tb)
    loss = model.loss_from_batch(out, tb)
    loss.backward()
    pred = out[0][0].detach().numpy()
    np.testing.assert_allclose(pred, pred_j, rtol=2e-4,
                               atol=2e-5 * np.abs(pred_j).max())
    np.testing.assert_allclose(float(loss.detach()), float(val_j), rtol=2e-4)
    exp = params_from_jax(jax.device_get(grad_j), model.state_dict())
    for name, p in model.named_parameters():
        e = exp[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), e, rtol=2e-4,
                                   atol=2e-4 * max(np.abs(e).max(), 1e-30),
                                   err_msg=name)
