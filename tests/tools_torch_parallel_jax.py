"""The JAX side of the port's multi-process tests: the dry run's narrow
models and batches in the JAX package, and one step of its Trainer on a
device mesh of the test process (the conftest's 8 host devices)."""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models.gnn.dynedge_kaggle_tito import DynEdgeTITO as JaxTITO
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    DirectionReconstructionWithKappa as JaxDirection,
    EnergyReconstruction as JaxEnergy,
)
from graphnet_tpu.parallel.graph_sharding import (
    graph_sharding_hints,
    make_dp_graph_mesh,
    shard_batch_nodes,
)
from graphnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from graphnet_tpu.training import loss_functions as jlf
from graphnet_tpu.training.trainer import Trainer as JaxTrainer
from graphnet_tpu_torch.ops.knn import knn_graph_plain
from graphnet_tpu_torch.parallel import dryrun
from graphnet_tpu_torch.utils.jax_params import params_from_jax


def jax_model(kind):
    """``dryrun.build_model(kind, width="narrow")`` in the JAX package."""
    if kind == "dynedge":
        backbone = JaxDynEdge(nb_inputs=4, **dryrun.NARROW)
    else:
        backbone = JaxTITO(nb_inputs=4, **dryrun.NARROW_TITO)
    return JaxStandardModel(backbone=backbone, tasks=(
        JaxEnergy(loss_function=jlf.LogCoshLoss(),
                  target_labels=("total_energy",),
                  transform_prediction_and_target=lambda x: jnp.log10(x)),
        JaxDirection(loss_function=jlf.VonMisesFisher3DLoss(),
                     target_labels=("direction",)),
    ))


def jax_batch(batch):
    """The port batch ``batch`` as the JAX package's batch."""
    n = batch.mask.sum(1).numpy()
    events = [batch.x[i, :n[i]].numpy() for i in range(batch.batch_size)]
    labels = {k: v.numpy() for k, v in batch.labels.items()}
    return jax_make_batch(events, labels=labels, length=batch.max_length)


def port_knn_in_jax(coords, mask, k, exclude_self=True):
    """The port's kNN, called from the JAX model (``pure_callback``): the
    random model's ReLU latents hold exact ties (zero columns), which the
    JAX package's CPU kNN breaks by its fp32 rounding and the port by
    the lower index (``tests/test_torch_examples.py``), so both packages
    build each graph by the port's rule from their own coordinates."""
    B, L = mask.shape

    def host(c, m):
        idx, em = knn_graph_plain(torch.from_numpy(np.array(c)),
                                  torch.from_numpy(np.array(m)), k,
                                  exclude_self)
        return idx.numpy().astype(np.int32), em.numpy()

    shapes = (jax.ShapeDtypeStruct((B, L, k), np.int32),
              jax.ShapeDtypeStruct((B, L, k), np.bool_))
    return jax.pure_callback(host, shapes, jax.lax.stop_gradient(coords),
                             mask)


@contextlib.contextmanager
def port_graphs():
    """Every kNN of the JAX models by :func:`port_knn_in_jax`."""
    import graphnet_tpu.models.components.layers as jlayers
    import graphnet_tpu.models.gnn.dynedge as jdynedge
    import graphnet_tpu.models.gnn.dynedge_kaggle_tito as jtito

    with contextlib.ExitStack() as stack:
        for module in (jlayers, jdynedge, jtito):
            stack.enter_context(mock.patch.object(module, "knn_graph",
                                                  port_knn_in_jax))
        yield


ONE_DEVICE = dict(axes=("data", "model"), shape=(1, 1), sharding="replicated")


_ONE_DEVICE_STEPS = {}


def one_device_step(kind, params, batch):
    """:func:`mesh_step` on ``ONE_DEVICE``, once per model and batch
    shape (the layouts of one model share their batch)."""
    key = (kind, batch.batch_size, batch.max_length)
    if key not in _ONE_DEVICE_STEPS:
        _ONE_DEVICE_STEPS[key] = mesh_step(kind, ONE_DEVICE, params, batch)
    return _ONE_DEVICE_STEPS[key]


def mesh_step(kind, spec, params, batch):
    """One step of the JAX Trainer on a 2-device mesh of the layout
    ``spec`` (``dryrun.layout_spec``) from the port's initial parameters
    ``params`` (the JAX tree): ``(loss, grads, params after)``; every kNN
    by :func:`port_graphs`.  ``ONE_DEVICE`` as ``spec``: the step on one
    device of a mesh (the JAX Trainer's numerics under a mesh)."""
    devices = jax.devices()[:spec["shape"][0] * spec["shape"][1]]
    graph = spec["axes"][1] == "graph"
    n_data, n_other = spec["shape"]
    mesh = (make_dp_graph_mesh(n_data, n_other, devices=devices) if graph
            else jax_make_mesh(n_data, n_other, devices=devices))
    model = jax_model(kind)
    trainer = JaxTrainer(model, learning_rate=1e-3, mesh=mesh,
                         param_sharding=spec["sharding"])
    jb = jax_batch(batch)
    sb = shard_batch_nodes(jb, mesh) if graph else trainer._shard_batch(jb)
    trainer.init(sb)
    trainer.state.params = trainer._replicate(params)
    trainer.state.opt_state = trainer._replicate(trainer.optimizer.init(params))

    def loss_fn(p, b):
        return model.loss_from_batch(model.apply(p, b), b)

    with port_graphs():
        with graph_sharding_hints(mesh):
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
                trainer.state.params, sb)
        trainer._make_steps()
        step_loss = trainer._single_train_step(sb)
    np.testing.assert_allclose(float(step_loss), float(loss), rtol=1e-6)
    return (float(loss), jax.device_get(grads),
            jax.device_get(trainer.state.params))


def in_port_names(step, expected):
    """A JAX step ``(loss, grads, params)`` with its trees as the port's
    state dicts (``expected``: the port model's)."""
    loss, grads, params = step
    return (loss, params_from_jax(grads, expected),
            params_from_jax(params, expected))


# Adam's first step from the same parameters moves an entry by
# ``lr g / (|g| + eps)`` (lr 1e-3 at step 0, eps 1e-3 in both Trainers),
# whose slope in ``g`` is at most ``lr / eps``
FIRST_STEP_SLOPE = 1e-3 / 1e-3


def assert_step_matches(got, exp, what, loss_rtol, rtol, atol):
    """One training step ``got = (loss, grads, params after)`` against
    another, ``exp``, from the same initial parameters (port names):

    * the loss within ``loss_rtol``;
    * each gradient entry within ``rtol`` of itself plus the larger of
      ``atol`` and ``rtol`` of its leaf's largest entry (fp32 sums in
      other orders at the random models' large gradients; the convention
      of ``tests/test_torch_stochastic.py``'s ``_assert_grads``);
    * each parameter entry within ``rtol`` / ``atol`` plus
      ``FIRST_STEP_SLOPE`` times its gradient's difference, which the
      line above bounds."""
    loss, grads, params = got
    exp_loss, exp_grads, exp_params = exp
    np.testing.assert_allclose(loss, exp_loss, rtol=loss_rtol,
                               err_msg=f"{what} loss")
    for name, e in exp_grads.items():
        g, e = _np(grads[name]), _np(e)
        np.testing.assert_allclose(
            g, e, rtol=rtol, atol=max(atol, rtol * float(np.abs(e).max())),
            err_msg=f"{what} grad {name}")
        p, q = _np(params[name]), _np(exp_params[name])
        excess = (np.abs(p - q) - atol - rtol * np.abs(q)
                  - FIRST_STEP_SLOPE * np.abs(g - e))
        assert excess.max() <= 0, (
            f"{what} param {name}: {excess.max()} beyond the tolerance "
            f"(|got - exp| max {np.abs(p - q).max()})")


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)
