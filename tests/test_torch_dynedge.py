"""The port's DynEdge StandardModel against the JAX package on the CPU,
with the JAX ``model.init`` weights carried over by ``params_from_jax``."""

import numpy as np
import pytest
import torch

import jax

from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.models.components.layers import EdgeConv as JaxEdgeConv
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    EnergyReconstruction as JaxEnergy,
)
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.models.components.layers import EdgeConv
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction
from graphnet_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(2)

NARROW = dict(
    dynedge_layer_sizes=((16, 32), (24, 32)),
    post_processing_layer_sizes=(24, 16),
    readout_layer_sizes=(8,),
)


def _events(seed, B=5, lo=6, hi=30):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((int(rng.integers(lo, hi)), 4)) * [50, 50, 50, 5])
        .astype(np.float32)
        for _ in range(B)
    ]


def _port_model(**kw):
    return StandardModel(
        DynEdge(nb_inputs=4, **NARROW, **kw),
        [EnergyReconstruction(hidden_size=8)],
        device="cpu",
    )


@pytest.fixture(scope="module")
def narrow_pair():
    events = _events(0)
    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4, **NARROW), tasks=(JaxEnergy(),)
    )
    params = jmodel.init(jax.random.PRNGKey(0), jax_make_batch(events, length=32))
    params = jax.device_get(params)
    model = _port_model()
    model.load_state_dict(params_from_jax(params, model.state_dict()))
    return jmodel, params, model.eval(), events


def test_narrow_dynedge_matches_jax(narrow_pair):
    jmodel, params, model, events = narrow_pair
    jb = jax_make_batch(events, length=32)
    tb = make_batch(events, length=32)
    j_lat = np.asarray(
        jmodel.backbone.apply({"params": params["params"]["backbone"]}, jb)
    )
    j_pred = np.asarray(jmodel.apply(params, jb, inference=True)[0][0])
    with torch.no_grad():
        t_lat = model.backbone(tb).numpy()
        t_pred = model(tb, inference=True)[0][0].numpy()
    assert t_lat.shape == (len(events), 8) and t_pred.shape == (len(events), 1)
    np.testing.assert_allclose(t_lat, j_lat, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(t_pred, j_pred, rtol=2e-4, atol=2e-5)


def test_padding_invariance(narrow_pair):
    _, _, model, events = narrow_pair
    with torch.no_grad():
        out32 = model(make_batch(events, length=32))[0][0].numpy()
        out64 = model(make_batch(events, length=64))[0][0].numpy()
    np.testing.assert_allclose(out32, out64, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize(
    "aggr,activation",
    [("add", "relu"), ("max", "leaky_relu"), ("mean", "relu"), ("min", "relu")],
)
def test_edgeconv_layer_matches_jax(aggr, activation):
    rng = np.random.default_rng(29)
    x = rng.standard_normal((2, 16, 6)).astype(np.float32)
    idx = rng.integers(0, 16, (2, 16, 4)).astype(np.int32)
    em = rng.random((2, 16, 4)) > 0.3
    em[1, 5] = False
    jconv = JaxEdgeConv((12, 10), aggr=aggr, activation=activation)
    params = jax.device_get(
        jconv.init(jax.random.PRNGKey(1), x, idx, em)
    )
    expected = np.asarray(jconv.apply(params, x, idx, em))
    conv = EdgeConv(6, (12, 10), aggr=aggr, activation=activation)
    conv.load_state_dict(params_from_jax(params, conv.state_dict()))
    assert conv.uses_kernel == (aggr != "min")
    with torch.no_grad():
        got = conv(
            torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(em)
        ).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)


def test_edgeconv_norm_layer_matches_jax():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 16, 6)).astype(np.float32)
    idx = rng.integers(0, 16, (2, 16, 4)).astype(np.int32)
    em = rng.random((2, 16, 4)) > 0.3
    jconv = JaxEdgeConv((12, 10, 8), aggr="add", add_norm_layer=True)
    params = jax.device_get(jconv.init(jax.random.PRNGKey(2), x, idx, em))
    conv = EdgeConv(6, (12, 10, 8), aggr="add", add_norm_layer=True)
    conv.load_state_dict(params_from_jax(params, conv.state_dict()))
    assert not conv.uses_kernel
    with torch.no_grad():
        got = conv(
            torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(em)
        ).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jconv.apply(params, x, idx, em)), rtol=1e-5, atol=1e-5
    )


@pytest.fixture(scope="module")
def full_width_tree():
    """The full-width JAX DynEdge energy model's parameter tree, as numpy
    arrays of the right shapes (``eval_shape``: no compile needed)."""
    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4), tasks=(JaxEnergy(),)
    )
    batch = jax_make_batch(_events(1, B=2, lo=4, hi=16), length=16)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes
    )


def test_params_from_jax_full_width(full_width_tree):
    tree = full_width_tree
    assert len(jax.tree_util.tree_leaves(tree)) == 28
    model = StandardModel(
        DynEdge(nb_inputs=4), [EnergyReconstruction(hidden_size=128)],
        device="cpu",
    )
    sd = params_from_jax(tree, model.state_dict())
    assert len(sd) == 28 == len(model.state_dict())
    model.load_state_dict(sd)
    p = tree["params"]["backbone"]
    conv0 = p["conv_0"]["conv"]
    assert conv0["self_dense"]["kernel"].shape == (13, 128)
    np.testing.assert_array_equal(
        sd["backbone.conv_0.conv.self_dense.weight"].numpy(),
        conv0["self_dense"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        sd["backbone.conv_1.conv.out_kernel"].numpy(),
        p["conv_1"]["conv"]["out_kernel"],
    )
    assert p["post_processing"]["dense_0"]["kernel"].shape == (1037, 336)
    assert p["readout"]["dense_0"]["kernel"].shape == (1024, 128)
    assert sd["tasks_0.affine.weight"].shape == (1, 128)


def test_params_from_jax_rejects_missing_and_extra_leaves(full_width_tree):
    model = StandardModel(
        DynEdge(nb_inputs=4), [EnergyReconstruction(hidden_size=128)],
        device="cpu",
    )
    expected = model.state_dict()
    missing = jax.tree_util.tree_map(lambda a: a, full_width_tree)
    del missing["params"]["backbone"]["conv_2"]["conv"]["out_bias"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, expected)
    extra = jax.tree_util.tree_map(lambda a: a, full_width_tree)
    extra["params"]["backbone"]["conv_9"] = {"conv": {"out_bias": np.zeros(3)}}
    with pytest.raises(ValueError, match="unused"):
        params_from_jax(extra, expected)
    odd = jax.tree_util.tree_map(lambda a: a, full_width_tree)
    odd["params"]["tasks_0"]["affine"]["gamma"] = np.zeros(1)
    with pytest.raises(ValueError, match="unknown kind"):
        params_from_jax(odd, expected)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_nested_deepice_dynedge_matches_jax(compute_dtype):
    """DeepIce's nested configuration: gelu, norm layers, no pooling and
    no readout, so the latents are per node.  Random parameters (norm
    scales and biases too); the valid nodes' latents and every gradient
    of a weighted sum of them against the JAX package (fp32: rtol 2e-4;
    bf16, the compute dtype DeepIce passes down, the latents within 2e-2
    of their max).  Its convs take the plain path, as in the JAX
    package."""
    kw = dict(nb_inputs=6, nb_neighbours=5, dynedge_layer_sizes=((16, 24),
              (24, 24)), post_processing_layer_sizes=(24, 12),
              global_pooling_schemes=None, activation_layer="gelu",
              add_norm_layer=True, skip_readout=True,
              compute_dtype=compute_dtype)
    rng = np.random.default_rng(41)
    events = [(rng.standard_normal((n, 6)) * [2, 2, 2, 1, 1, 1]).astype(
        np.float32) for n in (20, 7, 1, 13)]
    jb, tb = jax_make_batch(events, length=24), make_batch(events, length=24)
    jmodel = JaxDynEdge(**kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jb)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * (
            1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.5)).astype(
                np.float32), shapes)
    weight = rng.standard_normal((4, 24, 12)).astype(np.float32)
    mask = np.asarray(jb.mask)

    def jloss(p):
        lat = jmodel.apply(p, jb)
        return (lat * weight * mask[..., None]).sum(), lat

    (_, j_lat), j_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = DynEdge(**kw)
    assert not any(getattr(model, f"conv_{i}").conv.uses_kernel
                   for i in range(2))
    model.load_state_dict(params_from_jax(params, model.state_dict()))
    lat = model(tb)
    assert lat.shape == (4, 24, 12) and lat.dtype == torch.float32
    (lat * torch.from_numpy(weight) * tb.mask[..., None]).sum().backward()
    got, exp = lat.detach().numpy()[mask], np.asarray(j_lat)[mask]
    if compute_dtype is None:
        np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-5)
        exp_g = params_from_jax(jax.device_get(j_grads), model.state_dict())
        for name, p in model.named_parameters():
            e = exp_g[name].numpy()
            np.testing.assert_allclose(
                p.grad.numpy(), e, rtol=2e-4, atol=2e-5 * np.abs(e).max(),
                err_msg=name)
    else:
        assert np.abs(got - exp).max() < 2e-2 * np.abs(exp).max()
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())
