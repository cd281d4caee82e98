"""The port's DeploymentModule (on the CPU) against the JAX package's on
the same raw events, from the ``model.yml`` and ``state_dict.pkl`` that
the JAX package writes."""

import numpy as np
import torch

from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.deployment.deployment_module import (
    DeploymentModule as JaxDeploymentModule,
)
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models.graphs.graph_definition import Event as JaxEvent
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    EnergyReconstruction as JaxEnergy,
)
from graphnet_tpu.training.loss_functions import LogCoshLoss
from graphnet_tpu.training.trainer import Trainer
from graphnet_tpu.utils.config import TRANSFORM_REGISTRY, save_model_config
from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.graphs.graph_definition import Event
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import EnergyReconstruction

torch.set_num_threads(2)

NARROW = dict(
    dynedge_layer_sizes=((16, 32), (24, 32)),
    post_processing_layer_sizes=(24, 16),
    readout_layer_sizes=(8,),
)
FEATURES = ["sensor_pos_x", "sensor_pos_y", "sensor_pos_z", "t"]


def _arrays(seed, lengths):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((n, 4)) * [50, 50, 50, 5]).astype(np.float32)
        for n in lengths
    ]


def test_deployment_matches_jax(tmp_path):
    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4, **NARROW),
        tasks=(
            JaxEnergy(
                loss_function=LogCoshLoss(),
                transform_prediction_and_target=TRANSFORM_REGISTRY["log10"],
            ),
        ),
    )
    trainer = Trainer(jmodel)
    trainer.init(jax_make_batch(_arrays(0, [10, 20]), length=32))
    config_path = str(tmp_path / "model.yml")
    params_path = str(tmp_path / "state_dict.pkl")
    save_model_config(jmodel, config_path)
    trainer.save_state_dict(params_path)
    jax_module = JaxDeploymentModule(config_path, params_path)

    model = StandardModel(
        DynEdge(nb_inputs=4, **NARROW),
        [EnergyReconstruction(hidden_size=8)],
        device="cpu",
    )
    module = DeploymentModule(model, params_path, device="cpu")
    assert module.prediction_columns == jax_module.prediction_columns

    # five events (not a power of two), one of them with 0 pulses
    arrays = _arrays(1, [12, 0, 30, 7, 3])
    got = module([Event(x=a, features=FEATURES) for a in arrays])
    expected = jax_module([JaxEvent(x=a, features=FEATURES) for a in arrays])
    assert got.shape == (5, 1)
    assert np.isnan(got[1]).all() and np.isfinite(np.delete(got, 1, 0)).all()
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-5)

    # a single event answers as it does inside a batch
    single = module(Event(x=arrays[0], features=FEATURES))
    np.testing.assert_allclose(single[0], got[0], rtol=2e-4, atol=2e-5)
    assert np.isnan(module([Event(x=arrays[1], features=FEATURES)])).all()


def test_pad_batch_size_pads_with_masked_events():
    from graphnet_tpu_torch.data.dataloader import collate_events

    events = [Event(x=a, features=FEATURES) for a in _arrays(2, [5, 9, 3])]
    padded = DeploymentModule._pad_batch_size(
        collate_events(events, min_pulses=1)
    )
    assert padded.batch_size == 4 and padded.max_length == 16
    assert not padded.mask[3].any() and int(padded.n_pulses[3]) == 0
    assert padded.mask[:3].sum().item() == 17


def test_collate_and_make_batch_match_jax():
    from graphnet_tpu.data.dataloader import collate_events as jax_collate
    from graphnet_tpu_torch.batch import make_batch
    from graphnet_tpu_torch.data.dataloader import collate_events

    arrays = _arrays(3, [7, 1, 40, 0, 16])
    labels = [{"energy": float(i) + 0.5, "pid": 12 + i} for i in range(5)]
    node = [{"noise": np.arange(len(a), dtype=np.float32)} for a in arrays]
    tev = [Event(x=a, features=FEATURES, labels=l, node_labels=n)
           for a, l, n in zip(arrays, labels, node)]
    jev = [JaxEvent(x=a, features=FEATURES, labels=l, node_labels=n)
           for a, l, n in zip(arrays, labels, node)]
    got = collate_events(tev, min_pulses=1)
    exp = jax_collate(jev, min_pulses=1).unpacked()
    for name in ("x", "mask", "n_pulses"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(exp, name))
        )
    assert set(got.labels) == set(exp.labels) == {"energy", "pid"}
    for k in got.labels:
        np.testing.assert_array_equal(
            got.labels[k].numpy(), np.asarray(exp.labels[k])
        )
    np.testing.assert_array_equal(
        got.node_labels["noise"].numpy(), np.asarray(exp.node_labels["noise"])
    )

    tb = make_batch(arrays[:3], labels={"e": np.arange(3.0)}, length=64)
    jb = jax_make_batch(arrays[:3], labels={"e": np.arange(3.0)}, length=64)
    for name in ("x", "mask", "n_pulses"):
        np.testing.assert_array_equal(
            getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        )
    np.testing.assert_array_equal(tb.labels["e"].numpy(), np.asarray(jb.labels["e"]))


def test_node_level_deployment_matches_jax(tmp_path):
    import pickle

    import jax

    from graphnet_tpu.utils.config import save_model_config as save_config

    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4, skip_readout=True, **NARROW),
        tasks=(JaxEnergy(node_level=True),),
    )
    params = jmodel.init(
        jax.random.PRNGKey(3), jax_make_batch(_arrays(4, [10, 20]), length=32)
    )
    config_path = str(tmp_path / "model.yml")
    params_path = str(tmp_path / "state_dict.pkl")
    save_config(jmodel, config_path)
    with open(params_path, "wb") as f:
        pickle.dump(jax.device_get(params), f)
    jax_module = JaxDeploymentModule(config_path, params_path)

    model = StandardModel(
        DynEdge(nb_inputs=4, skip_readout=True, **NARROW),
        [EnergyReconstruction(hidden_size=16, node_level=True)],
        device="cpu",
    )
    module = DeploymentModule(model, params_path, device="cpu")
    arrays = _arrays(5, [9, 0, 21])
    got = module([Event(x=a, features=FEATURES) for a in arrays])
    expected = jax_module([JaxEvent(x=a, features=FEATURES) for a in arrays])
    assert [g.shape for g in got] == [(9, 1), (0, 1), (21, 1)]
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g, e, rtol=2e-4, atol=2e-5)
