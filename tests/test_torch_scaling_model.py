"""The port's weak-scaling model against the JAX package's
(``parallel/scaling_model.py``): the ring formulas, ``predict_scaling``
and ``dynedge_headline_profile`` at the same link bandwidth within 1e-12,
the required ``link_gbps``, and the headline DynEdge's parameter count,
which must be the JAX model's exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from graphnet_tpu.parallel import scaling_model as jsm
from graphnet_tpu_torch.parallel import scaling_model as tsm

LINKS = (25.0, 50.0, 450.0)
MESHES = ((1, 1), (2, 1), (8, 1), (2, 4), (4, 4), (16, 1))


def _profiles(m):
    return [m.CollectiveProfile(4e6), m.CollectiveProfile(4e6, 6.6e6),
            m.CollectiveProfile(4e6, 6.6e6, halo_async=False),
            m.dynedge_headline_profile(1_378_769)]


def _fields(pred):
    d = dataclasses.asdict(pred)
    return d.pop("mesh_shape"), d.pop("detail"), d


@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("mesh", MESHES)
def test_predict_scaling_matches_jax(mesh, link):
    for tp, jp in zip(_profiles(tsm), _profiles(jsm)):
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        for step_ms, events in ((5.62, 128), (0.3, None)):
            got = tsm.predict_scaling(step_ms, tp, n_data=mesh[0],
                                      n_graph=mesh[1], events_per_step=events,
                                      link_gbps=link)
            exp = jsm.predict_scaling(step_ms, jp, n_data=mesh[0],
                                      n_graph=mesh[1], events_per_step=events,
                                      link_gbps=link)
            (gm, gd, g), (em, ed, e) = _fields(got), _fields(exp)
            assert gm == em and gd.keys() == ed.keys()
            for k in g:
                assert g[k] == pytest.approx(e[k], rel=1e-12, abs=1e-12), k
            for k in gd:
                assert gd[k] == pytest.approx(ed[k], rel=1e-12, abs=1e-12), k


def test_formulas():
    p = tsm.CollectiveProfile(grad_allreduce_bytes=4e6, halo_allgather_bytes=1e7)
    one = tsm.predict_scaling(5.0, p, n_data=1, link_gbps=50.0)
    assert one.efficiency_expected == one.efficiency_conservative == 1.0
    t8 = tsm.predict_scaling(5.0, p, n_data=8, link_gbps=50.0).t_allreduce_ms
    assert t8 == pytest.approx(2 * 7 / 8 * 4e6 / 50e9 * 1e3, rel=1e-12)
    pred = tsm.predict_scaling(5.0, p, n_data=2, n_graph=4, link_gbps=50.0)
    assert pred.t_halo_ms == pytest.approx(3 / 4 * 1e7 / 50e9 * 1e3, rel=1e-12)
    assert pred.efficiency_conservative <= pred.efficiency_expected <= 1.0
    assert tsm.dynedge_headline_profile(10).grad_allreduce_bytes == 40.0


@pytest.mark.parametrize("link", [None, 0.0, -1.0])
def test_link_is_required(link):
    """No default link figure: leaving ``link_gbps`` out (None here) is a
    ``TypeError``, a figure that is not positive a ``ValueError``."""
    p = tsm.CollectiveProfile(4e6)
    if link is None:
        with pytest.raises(TypeError, match="link_gbps"):
            tsm.predict_scaling(5.0, p, n_data=2)
        with pytest.raises(TypeError):
            tsm.predict_scaling(5.0, p, 2, 1, None, 50.0)
    else:
        with pytest.raises(ValueError, match="link_gbps"):
            tsm.predict_scaling(5.0, p, n_data=2, link_gbps=link)
    assert not hasattr(tsm, "ICI_LINK_GBPS")


def test_headline_param_count_is_the_jax_models():
    """``DynEdge(nb_inputs=4)`` at its full width with the energy head, as
    the JAX package's headline model (its parameter count by
    ``eval_shape`` of ``init``): the same number of parameters, so the
    same all-reduce bytes."""
    import jax.numpy as jnp

    import bench
    from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
    from graphnet_tpu.models.standard_model import StandardModel as JaxModel
    from graphnet_tpu.models.task.reconstruction import (
        EnergyReconstruction as JaxEnergy,
    )
    from graphnet_tpu.training.loss_functions import LogCoshLoss as JaxLogCosh
    from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import (
        EnergyReconstruction,
    )
    from graphnet_tpu_torch.training.loss_functions import LogCoshLoss

    assert bench.D == 4
    jmodel = JaxModel(
        backbone=JaxDynEdge(nb_inputs=4, compute_dtype="bfloat16"),
        tasks=(JaxEnergy(loss_function=JaxLogCosh(),
                         target_labels=("total_energy",),
                         transform_prediction_and_target=jnp.log10),))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            bench._synthetic_batch(seed=0, batch_size=2))
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes))
    backbone = DynEdge(nb_inputs=4)
    model = StandardModel(
        backbone, [EnergyReconstruction(
            hidden_size=backbone.nb_outputs, loss_function=LogCoshLoss(),
            target_labels=("total_energy",),
            transform_prediction_and_target=torch.log10)], device="cpu")
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == n_jax
    assert (tsm.dynedge_headline_profile(n_port).grad_allreduce_bytes
            == jsm.dynedge_headline_profile(n_jax).grad_allreduce_bytes)
