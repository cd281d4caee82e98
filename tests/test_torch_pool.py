"""The port's pooling, grouping and coarsening against the JAX package on
the CPU (equal outputs on the same events and arrays), and the frozen
batch-norm statistics of ported ConvNet and ParticleNeT models under a
weight-decaying optimiser (``utils/weight_port.frozen_stat_decay_mask``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphnet_tpu.models import coarsening as jcoarse
from graphnet_tpu.models.components import pool as jpool
from graphnet_tpu.models.graphs.graph_definition import Event as JaxEvent
from graphnet_tpu.utils import weight_port as jweight_port
from graphnet_tpu_torch.models import coarsening as tcoarse
from graphnet_tpu_torch.models.components import pool as tpool
from graphnet_tpu_torch.models.graphs.graph_definition import Event
from graphnet_tpu_torch.utils import weight_port
from graphnet_tpu_torch.utils.jax_params import params_to_jax

torch.set_num_threads(2)

FEATURES = ["dom_x", "dom_y", "dom_z", "rde", "pmt_area", "dom_time", "charge",
            "pmt_number"]


def _events(seed, n=40):
    """Pulses on 6 DOMs of 3 PMTs each, times spread so that some DOMs'
    pulses fall in more than one time window, and node and event
    labels."""
    rng = np.random.default_rng(seed)
    doms = rng.integers(0, 6, n)
    pos = rng.standard_normal((6, 3)).round(2) * 100
    x = np.concatenate([
        pos[doms], np.ones((n, 1)), np.full((n, 1), 0.5),
        rng.uniform(0, 400, (n, 1)).round(1), rng.uniform(0.2, 3, (n, 1)),
        rng.integers(0, 3, (n, 1))], axis=1).astype(np.float32)
    labels = {"energy": 12.5, "zenith": 0.3}
    node_labels = {"noise": (rng.random(n) > 0.7).astype(np.float32)}
    return (Event(x=x, features=list(FEATURES), labels=labels,
                  node_labels=node_labels),
            JaxEvent(x=x, features=list(FEATURES), labels=labels,
                     node_labels=node_labels))


def _same_event(got, exp):
    np.testing.assert_array_equal(got.x, exp.x)
    assert got.x.dtype == exp.x.dtype
    assert got.features == exp.features and got.labels == exp.labels
    assert got.node_labels.keys() == exp.node_labels.keys()
    for k in got.node_labels:
        np.testing.assert_array_equal(got.node_labels[k], exp.node_labels[k])


COARSENINGS = [
    ("DOMCoarsening", dict(reduce="avg")),
    ("DOMCoarsening", dict(reduce="max", transfer_attributes=False)),
    ("AttributeCoarsening", dict(attributes=["dom_x", "dom_y", "dom_z"],
                                 reduce="min")),
    ("AttributeCoarsening", dict(attributes=["dom_x", "pmt_number"],
                                 reduce="sum")),
    ("CustomDOMCoarsening", {}),
    ("DOMAndTimeWindowCoarsening", dict(time_window=40.0)),
]


@pytest.mark.parametrize("name,kw", COARSENINGS,
                         ids=["dom_avg", "dom_max_no_transfer", "attr_min",
                              "attr_sum", "custom_dom", "time_window"])
def test_coarsening_matches_jax(name, kw):
    for seed in (0, 1):
        tev, jev = _events(seed)
        _same_event(getattr(tcoarse, name)(**kw)(tev),
                    getattr(jcoarse, name)(**kw)(jev))


def test_coarsening_refuses_an_unknown_reduction():
    with pytest.raises(ValueError, match="median"):
        tcoarse.DOMCoarsening(reduce="median")


def test_group_by_matches_jax():
    tev, _ = _events(2)
    np.testing.assert_array_equal(
        tpool.group_by_np(tev.x, [0, 5]), jpool.group_by_np(tev.x, [0, 5]))
    np.testing.assert_array_equal(
        tpool.group_pulses_to_dom(tev.x, FEATURES),
        jpool.group_pulses_to_dom(tev.x, FEATURES))
    np.testing.assert_array_equal(
        tpool.group_pulses_to_pmt(tev.x, FEATURES),
        jpool.group_pulses_to_pmt(tev.x, FEATURES))


@pytest.mark.parametrize("aggr", ["sum", "add", "mean", "min", "max"])
def test_segment_pool_matches_jax(aggr):
    """Reductions over cluster ids, a cluster left empty, 1-D and 2-D
    features; and the pooled sums given back to every member."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((30, 5)).astype(np.float32)
    cluster = rng.choice([0, 1, 2, 4, 5], 30)  # cluster 3 empty
    for v in (x, x[:, 0]):
        got = tpool.segment_pool(torch.from_numpy(v), torch.from_numpy(cluster),
                                 6, aggr)
        exp = jpool.segment_pool(jnp.asarray(v), jnp.asarray(cluster), 6, aggr)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="median"):
        tpool.segment_pool(torch.from_numpy(x), torch.from_numpy(cluster), 6,
                           "median")


def test_sum_pool_and_distribute_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((20, 3)).astype(np.float32)
    cluster = rng.integers(0, 4, 20)
    np.testing.assert_allclose(
        tpool.sum_pool_and_distribute(torch.from_numpy(x),
                                      torch.from_numpy(cluster), 4).numpy(),
        np.asarray(jpool.sum_pool_and_distribute(jnp.asarray(x),
                                                 jnp.asarray(cluster), 4)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["min_pool", "max_pool", "sum_pool",
                                  "avg_pool", "std_pool"])
def test_pool_aliases_match_jax(name):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 10, 4)).astype(np.float32)
    mask = np.arange(10)[None] < np.array([10, 4, 1])[:, None]
    np.testing.assert_allclose(
        getattr(tpool, name)(torch.from_numpy(x), torch.from_numpy(mask)).numpy(),
        np.asarray(getattr(jpool, name)(jnp.asarray(x), jnp.asarray(mask))),
        rtol=1e-5, atol=1e-6)


# ------------------------------------------- frozen statistics and decay
def _ported_model(kind):
    from graphnet_tpu_torch.models.gnn.convnet import ConvNet
    from graphnet_tpu_torch.models.gnn.particlenet import ParticleNeT
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
    from graphnet_tpu_torch.training.loss_functions import LogCoshLoss

    backbone = (ConvNet(nb_inputs=4, nb_outputs_=1, nb_intermediate=16,
                        frozen_batchnorm=True) if kind == "ConvNet"
                else ParticleNeT(nb_inputs=4, nb_neighbours=4,
                                 dynedge_layer_sizes=((8, 8), (16, 16)),
                                 readout_layer_sizes=(8,),
                                 frozen_batchnorm=True))
    model = StandardModel(backbone, [EnergyReconstruction(
        hidden_size=backbone.nb_outputs, loss_function=LogCoshLoss(),
        target_labels=("total_energy",))], device="cpu")
    with torch.no_grad():  # statistics as a checkpoint carries them
        for name, buf in model.named_buffers():
            if name.rsplit(".", 1)[-1] in weight_port.FROZEN_STATISTICS:
                buf.copy_(torch.rand_like(buf) + 0.5)
    return model


@pytest.mark.parametrize("kind", ["ConvNet", "ParticleNeT"])
def test_frozen_statistics_mask_matches_jax_and_decay_leaves_them(kind):
    """The mask names what the JAX package's ``frozen_stat_decay_mask``
    names, on the same model's JAX tree; and AdamW steps with weight decay
    (all parameters, and groups built from the mask) leave the frozen
    statistics bit for bit, as they are buffers, while they decay the
    parameters."""
    from graphnet_tpu_torch.batch import make_batch

    model = _ported_model(kind)
    mask = weight_port.frozen_stat_decay_mask(model)
    frozen = sorted(n for n, decay in mask.items() if not decay)
    assert frozen and all(n.rsplit(".", 1)[-1] in weight_port.FROZEN_STATISTICS
                          for n in frozen)
    jmask = jweight_port.frozen_stat_decay_mask(
        params_to_jax(model.state_dict()))
    flat = {".".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(jmask)}
    assert sorted(k[len("params."):] for k, v in flat.items() if not v) == [
        ".".join(n.split(".")[:-1] + [n.split(".")[-1]]) for n in frozen]

    stats = {n: b.clone() for n, b in model.named_buffers() if n in mask
             and not mask[n]}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(6)
    events = [rng.standard_normal((12, 4)).astype(np.float32) for _ in range(3)]
    batch = make_batch(events, labels={"total_energy": np.array(
        [10.0, 50.0, 200.0], np.float32)}, length=16)
    decay = [p for n, p in model.named_parameters() if mask[n]]
    rest = [p for n, p in model.named_parameters() if not mask[n]]
    for opt in (torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.1),
                torch.optim.AdamW([{"params": decay},
                                   {"params": rest, "weight_decay": 0.0}],
                                  lr=1e-3, weight_decay=0.1)):
        model.train()
        opt.zero_grad()
        model.loss_from_batch(model(batch), batch).backward()
        opt.step()
    for n, s in stats.items():
        assert torch.equal(dict(model.named_buffers())[n], s), n
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    # decay moves every parameter that is not zero (a zero bias with no
    # gradient, as before a batch norm, stays zero)
    assert moved >= {n for n, b in before.items() if bool(b.any())}
