"""The port's serving from files on the CPU: ``DeploymentModule(model.yml,
state_dict.pkl)`` against the JAX package's (graph level and node level),
``ServingQueue`` and ``serve_events_parallel`` (order, exceptions,
draining, against a direct call and against the JAX queue), ``Deployer``
(the JAX shard split; two spawned workers against one process) and
``load_dataset`` of the bundled dataset config with its string
selections."""

import copy
import pickle
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax

import graphnet_tpu.utils.config as jconfig
from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.data.string_selection_resolver import (
    StringSelectionResolver as JaxResolver,
)
from graphnet_tpu.deployment.deployer import Deployer as JaxDeployer
from graphnet_tpu.deployment.deployment_module import (
    DeploymentModule as JaxDeploymentModule,
)
from graphnet_tpu.deployment.serving_queue import (
    serve_events_parallel as jax_serve_parallel,
)
from graphnet_tpu.models.graphs.graph_definition import Event as JaxEvent
from graphnet_tpu_torch.data.string_selection_resolver import (
    StringSelectionResolver,
)
from graphnet_tpu_torch.deployment.deployer import Deployer
from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
from graphnet_tpu_torch.deployment.serving_queue import (
    ServingQueue,
    serve_events_parallel,
)
from graphnet_tpu_torch.models.graphs.graph_definition import Event
from graphnet_tpu_torch.utils import config
from tests.tools_torch_deployer import FailingDeployer, NpzDeployer, write_events

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
MODELS = ROOT / "configs" / "models"
ENERGY = "dynedge_energy_prometheus.yml"
CLEANER = "zoo/queso/SplitInIcePulses_cleaner/model.yml"
NARROW = dict(dynedge_layer_sizes=[[16, 32], [24, 32]],
              post_processing_layer_sizes=[24, 16], readout_layer_sizes=[8])


def _narrow_files(name, tmp_path, seed=5):
    """The file with a narrow DynEdge (its heads and transforms as they
    are), and random JAX-layout weights for it: ``(model.yml,
    state_dict.pkl, nb_inputs)``."""
    with open(MODELS / name) as f:
        d = yaml.safe_load(f)
    args = d["arguments"]["backbone"]["__model__"]["arguments"]
    args.update(copy.deepcopy(NARROW))
    yml, pkl = tmp_path / "model.yml", tmp_path / "state_dict.pkl"
    yml.write_text(yaml.safe_dump(d, sort_keys=False))
    jmodel = jconfig.load_model(str(yml))
    nb = args["nb_inputs"]
    batch = jax_make_batch([np.zeros((4, nb), np.float32)], length=16)
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.5
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    params = jax.tree_util.tree_map(
        draw, jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch))
    # a small head kernel keeps the sigmoid and log outputs off their
    # flat sides (the latents reach ~1e2)
    head = params["params"]["tasks_0"]["affine"]
    head["kernel"] = head["kernel"] * 1e-2
    with open(pkl, "wb") as f:
        pickle.dump(params, f)
    return str(yml), str(pkl), nb


def _arrays(seed, lengths, nb):
    rng = np.random.default_rng(seed)
    scale = np.ones(nb)
    scale[:3] = 50.0
    return [(rng.standard_normal((n, nb)) * scale).astype(np.float32)
            for n in lengths]


def _features(nb):
    return [f"f{i}" for i in range(nb)]


@pytest.fixture(scope="module")
def energy(tmp_path_factory):
    """The energy file's narrow model on the CPU, with its files."""
    yml, pkl, nb = _narrow_files(ENERGY, tmp_path_factory.mktemp("energy"))
    return DeploymentModule(yml, pkl, device="cpu"), yml, pkl, nb


def test_graph_level_module_from_files_matches_jax(energy):
    """Five events (one with 0 pulses, a NaN row) through both packages'
    ``DeploymentModule(model.yml, state_dict.pkl)``, rtol 2e-4."""
    module, yml, pkl, nb = energy
    jmodule = JaxDeploymentModule(yml, pkl)
    assert module.prediction_columns == jmodule.prediction_columns
    assert next(module.model.parameters()).device.type == "cpu"
    arrays = _arrays(1, [12, 0, 30, 7, 3], nb)
    got = module([Event(x=a, features=_features(nb)) for a in arrays])
    exp = jmodule([JaxEvent(x=a, features=_features(nb)) for a in arrays])
    assert got.shape == (5, 1)
    assert np.isnan(got[1]).all() and np.isfinite(np.delete(got, 1, 0)).all()
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-5)


def test_node_level_module_from_files_matches_jax(tmp_path):
    """The QUESO pulse cleaner (node level, no pooling): per-pulse
    answers, a 0-pulse event an empty array, rtol 2e-4."""
    yml, pkl, nb = _narrow_files(CLEANER, tmp_path)
    module = DeploymentModule(yml, pkl, device="cpu")
    jmodule = JaxDeploymentModule(yml, pkl)
    arrays = _arrays(2, [9, 0, 16, 1], nb)
    got = module([Event(x=a, features=_features(nb)) for a in arrays])
    exp = jmodule([JaxEvent(x=a, features=_features(nb)) for a in arrays])
    assert [g.shape for g in got] == [(9, 1), (0, 1), (16, 1), (1, 1)]
    for g, e in zip(got, exp):
        assert np.isfinite(g).all() and ((g > 0) & (g < 1)).all(), g
        np.testing.assert_allclose(g, e, rtol=2e-4, atol=2e-5)


def test_module_pickles_as_its_files(energy):
    module, yml, pkl, nb = energy
    again = pickle.loads(pickle.dumps(module))
    assert again is not module and again.device == module.device
    events = [Event(x=a, features=_features(nb))
              for a in _arrays(3, [5, 8], nb)]
    np.testing.assert_array_equal(again(events), module(events))


# ------------------------------------------------------------ the queue
def test_serve_events_parallel_keeps_order_and_matches_a_direct_call(energy):
    """24 events of 1-16 pulses from 4 threads in batches of at most 4:
    each answer in its input position, within rtol 1e-4 of one direct
    call on all of them; the collector ran batches of more than one."""
    module, _, _, nb = energy
    events = [Event(x=a, features=_features(nb)) for a in
              _arrays(4, np.random.default_rng(4).integers(1, 17, 24), nb)]
    sizes = []

    def recording(evs):  # the first call waits while the rest queue up
        if not sizes:
            time.sleep(0.2)
        sizes.append(len(evs))
        return module(evs)

    got = serve_events_parallel(recording, events, n_workers=4, max_batch=4,
                                max_wait_ms=20.0)
    direct = module(events)
    assert len(got) == len(events) and max(sizes) <= 4 and max(sizes) > 1
    np.testing.assert_allclose(np.stack(got), direct, rtol=1e-4, atol=1e-6)


def test_serve_events_parallel_matches_jax(energy):
    module, yml, pkl, nb = energy
    arrays = _arrays(5, [3, 11, 16, 1, 7, 9], nb)
    got = serve_events_parallel(
        module, [Event(x=a, features=_features(nb)) for a in arrays],
        n_workers=3, max_batch=4)
    exp = jax_serve_parallel(
        JaxDeploymentModule(yml, pkl),
        [JaxEvent(x=a, features=_features(nb)) for a in arrays],
        n_workers=3, max_batch=4)
    np.testing.assert_allclose(np.stack(got), np.stack(exp), rtol=2e-4,
                               atol=2e-5)


def test_an_exception_reaches_every_future():
    gate = threading.Event()

    def failing(events):
        gate.wait(5)
        raise ValueError(f"bad batch of {len(events)}")

    sq = ServingQueue(failing, max_batch=8, max_wait_ms=50.0)
    futs = [sq.submit(i) for i in range(5)]
    gate.set()
    for f in futs:
        with pytest.raises(ValueError, match="bad batch"):
            f.result(timeout=10)
    sq.close()


def test_close_drains_pending_work_and_refuses_more():
    """Events submitted before ``close`` are all served (in batches of at
    most 2, slowly); ``submit`` after it raises."""

    def slow(events):
        time.sleep(0.05)
        return np.asarray([[float(e)] for e in events])

    sq = ServingQueue(slow, max_batch=2, max_wait_ms=0.0)
    futs = [sq.submit(i) for i in range(7)]
    sq.close(timeout=30)
    assert all(f.done() for f in futs)
    assert [float(f.result()[0]) for f in futs] == list(range(7))
    with pytest.raises(RuntimeError, match="closed"):
        sq.submit(0)


def test_queue_under_thread_stress():
    """32 threads (more than the cores) submit 640 events with a short
    switch interval while the queue coalesces them: every future gets its
    own event's answer, no batch exceeds the cap, and ``close`` leaves
    nothing pending."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    sizes = []

    def echo(events):
        sizes.append(len(events))
        return np.asarray([[float(e)] for e in events])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sq = ServingQueue(echo, max_batch=16, max_wait_ms=0.5)
        with ThreadPoolExecutor(32) as pool:
            futs = list(pool.map(sq.submit, range(640)))
        sq.close(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not sq._thread.is_alive()
    assert [float(f.result(timeout=5)[0]) for f in futs] == list(range(640))
    assert sum(sizes) == 640 and max(sizes) <= 16


# ------------------------------------------------------------ Deployer
@pytest.mark.parametrize("n_files,n_workers", [(7, 2), (7, 3), (2, 4), (5, 1)])
def test_shards_match_jax(n_files, n_workers):
    files = [f"f{i}.npz" for i in range(n_files)]
    got = Deployer([], n_workers)._prepare_settings(files)
    exp = JaxDeployer([], n_workers)._prepare_settings(files)
    assert [list(map(str, s)) for s in got] == [list(map(str, s)) for s in exp]


def test_two_spawned_workers_match_one_process(energy, tmp_path):
    """Five ``.npz`` files served by two spawned workers (each builds the
    module from the model.yml) and by one process: the same answers."""
    module, _, _, nb = energy
    rng = np.random.default_rng(6)
    files = []
    for i in range(5):
        path = str(tmp_path / f"events_{i}.npz")
        write_events(path, _arrays(10 + i, rng.integers(0, 17, 3), nb))
        files.append(path)
    outs = {}
    for n in (1, 2):
        out = tmp_path / f"out_{n}"
        out.mkdir()
        NpzDeployer([module], n, str(out), _features(nb)).run(files)
        outs[n] = {p.name: np.load(p) for p in out.iterdir()}
    assert sorted(outs[2]) == sorted(outs[1]) and len(outs[1]) == 5
    for name in outs[1]:
        np.testing.assert_array_equal(outs[2][name], outs[1][name])


def test_a_failing_worker_fails_the_run():
    with pytest.raises(RuntimeError, match="2 of 2 deployer workers failed"):
        FailingDeployer([], 2).run(["a", "b"])


# ------------------------------------------------------------ datasets
DATASET = ROOT / "configs" / "datasets" / "training_example_data_sqlite.yml"


def test_load_dataset_matches_jax():
    """The bundled dataset config's ``train`` and ``validation`` string
    selections give the JAX datasets' events, in order; the first event
    of each is the same."""
    got, exp = config.load_dataset(str(DATASET)), jconfig.load_dataset(
        str(DATASET))
    assert set(got) == set(exp) == {"train", "validation"}
    for name in got:
        assert got[name]._indices == exp[name]._indices
        assert len(got[name]) == len(exp[name]) > 0
        a, b = got[name][0], exp[name][0]
        np.testing.assert_array_equal(a.x, b.x)
        assert a.labels.keys() == b.labels.keys()
        for key in a.labels:
            np.testing.assert_array_equal(a.labels[key], b.labels[key])
    assert config.capture_config(got["train"]).as_dict() == (
        jconfig.capture_config(exp["train"]).as_dict())


def test_dataset_and_training_configs_cross_packages(tmp_path):
    """``save_dataset_config`` of the port's train dataset loads in the
    JAX package with the same events, and a ``TrainingConfig`` the port
    dumps loads in the JAX package as the same values."""
    train = config.load_dataset(str(DATASET))["train"]
    path = str(tmp_path / "dataset.yml")
    config.save_dataset_config(train, path)
    assert jconfig.load_dataset(path)._indices == train._indices
    tc = config.TrainingConfig(target="total_energy", early_stopping_patience=3,
                               fit={"max_epochs": 2},
                               dataloader={"batch_size": 16})
    tc.dump(str(tmp_path / "training.yml"))
    back = jconfig.TrainingConfig.load(str(tmp_path / "training.yml"))
    assert (back.target, back.early_stopping_patience, back.fit,
            back.dataloader) == (tc.target, 3, tc.fit, tc.dataloader)
    assert config.TrainingConfig.load(str(tmp_path / "training.yml")) == tc


@pytest.mark.parametrize("selection", [
    "event_no % 5 > 0",
    "7 random events ~ injection_type == 14",
    "30% random events ~ event_no % 2 == 0",
])
def test_string_selection_matches_jax(selection):
    ds = config.load_dataset(str(DATASET))["train"]
    jds = jconfig.load_dataset(str(DATASET))["train"]
    got = StringSelectionResolver(ds, seed=3).resolve(selection)
    exp = JaxResolver(jds, seed=3).resolve(selection)
    assert got == exp and len(got) > 0
