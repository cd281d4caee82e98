"""The port's training labels, argument parser and the four training
examples against the JAX package on the CPU: ``Direction`` and
``Track`` on the bundled database, ``ArgumentParser`` and ``Options``,
and each example's command line (``--device cpu``, one epoch), its
predictions within 1e-4 of the JAX example's from the same initial
parameters."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax

from graphnet_tpu.data.constants import FEATURES as JAX_FEATURES
from graphnet_tpu.data.constants import TRUTH as JAX_TRUTH
from graphnet_tpu.data.dataloader import DataLoader as JaxDataLoader
from graphnet_tpu.data.sqlite_dataset import SQLiteDataset as JaxSQLiteDataset
from graphnet_tpu.models.detector.prometheus import Prometheus as JaxPrometheus
from graphnet_tpu.models.graphs import KNNGraph as JaxKNNGraph
from graphnet_tpu.training import labels as jlabels
from graphnet_tpu.utils import argparse as jargparse
from graphnet_tpu.utils import config as jconfig
from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA, GRAPHNET_ROOT_DIR
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.graphs import KNNGraph
from graphnet_tpu_torch.training import labels
from graphnet_tpu_torch.utils import argparse as targparse
from graphnet_tpu_torch.utils import config
from graphnet_tpu_torch.ops.knn import knn_graph_plain
from graphnet_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_data import JaxLatentGraphs
from tests.tools_torch_icetray import icetray  # noqa: F401

torch.set_num_threads(2)

LABELS = {
    "direction": ("Direction", dict(azimuth_key="injection_azimuth",
                                    zenith_key="injection_zenith")),
    "track": ("Track", dict(pid_key="injection_type",
                            interaction_key="injection_interaction_type")),
}


def _label_datasets():
    kw = dict(pulsemaps="total", truth_table="mc_truth")
    jds = JaxSQLiteDataset(
        EXAMPLE_SQLITE_DATA, JaxKNNGraph(detector=JaxPrometheus()),
        features=JAX_FEATURES.PROMETHEUS, truth=JAX_TRUTH.PROMETHEUS,
        labels={k: getattr(jlabels, c)(**a) for k, (c, a) in LABELS.items()},
        **kw)
    tds = SQLiteDataset(
        EXAMPLE_SQLITE_DATA, KNNGraph(detector=Prometheus()),
        features=FEATURES.PROMETHEUS, truth=TRUTH.PROMETHEUS,
        labels={k: getattr(labels, c)(**a) for k, (c, a) in LABELS.items()},
        **kw)
    return jds, tds


def test_labels_match_jax_on_the_bundled_data():
    """``Direction`` and ``Track`` per event and batched (the loader's
    route), on every event of the bundled database: bit for bit."""
    jds, tds = _label_datasets()
    assert len(tds) == len(jds) == 50
    for i in range(len(tds)):
        for key in LABELS:
            np.testing.assert_array_equal(tds[i].labels[key],
                                          jds[i].labels[key], err_msg=key)
    got = next(iter(DataLoader(tds, batch_size=50)))
    exp = next(iter(JaxDataLoader(jds, batch_size=50))).unpacked()
    for key in LABELS:
        np.testing.assert_array_equal(got.labels[key].numpy(),
                                      np.asarray(exp.labels[key]), err_msg=key)
    direction = got.labels["direction"].numpy()
    np.testing.assert_allclose(np.linalg.norm(direction, axis=1), 1, rtol=1e-6)


@pytest.mark.parametrize("name", list(LABELS))
def test_label_configs_match_jax(name):
    """A label's captured config equals the JAX one's and builds through
    the port's registry."""
    cls, kw = LABELS[name]
    jlabel = getattr(jlabels, cls)(**kw)
    label = getattr(labels, cls)(**kw)
    assert (config.capture_config(label).as_dict()
            == jconfig.capture_config(jlabel).as_dict())
    again = config.build(config.capture_config(label))
    assert type(again) is type(label) and again.key == label.key


def test_argument_parser_matches_jax():
    args = [("batch-size", 16), "max-epochs", "early-stopping-patience",
            "learning-rate", "pulsemap"]
    got = targparse.ArgumentParser().with_standard_arguments(*args)
    exp = jargparse.ArgumentParser().with_standard_arguments(*args)
    assert vars(got.parse_args([])) == vars(exp.parse_args([]))
    argv = ["--batch-size", "3", "--max-epochs", "2", "--learning-rate", "0.1"]
    assert vars(got.parse_args(argv)) == vars(exp.parse_args(argv))
    with pytest.raises(KeyError):
        targparse.ArgumentParser().with_standard_arguments("no-such")
    options = targparse.Options("a", ("b", 3))
    assert options.contains("b") and not options.contains("c")
    assert options.pop_default("a") is None and options.pop_default("b") == 3


# ------------------------------------------------------------ examples
JAX_EXAMPLES = os.path.join(GRAPHNET_ROOT_DIR, "examples", "03_training")
EXAMPLES = {
    # port module: (JAX example file, arguments of both, prediction loader)
    "train_tito_direction": ("02_train_tito_direction.py", [], "train"),
    "train_deepice": ("03_train_deepice.py", [], "train"),
    "train_from_config": ("04_train_from_config.py", [], "val"),
    "train_rnn_tito": ("05_train_rnn_tito.py", [], "train"),
}


def _port_knn_in_jax(coords, mask, k, exclude_self=True):
    """The port's kNN, called from the JAX model (``pure_callback``).
    The bundled detector is a grid, so many distances tie, and the JAX
    package's CPU kNN breaks ties by its fp32 rounding, the port by the
    lower index (``tests/test_torch_data.py::WithInputGraph``): both
    models get the port's graph of their inputs."""
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


def _one_graph(monkeypatch):
    """Both packages' models on one graph: the input graphs of TITO and
    DynEdge the port's (:func:`_port_knn_in_jax`), DynEdge's latent
    graphs the JAX model's, replayed into the port's
    (``tests/test_torch_data.py::JaxLatentGraphs``)."""
    import graphnet_tpu.models.gnn.dynedge as jdynedge
    import graphnet_tpu.models.gnn.dynedge_kaggle_tito as jtito

    monkeypatch.setattr(jtito, "knn_graph", _port_knn_in_jax)
    monkeypatch.setattr(jdynedge, "knn_graph", _port_knn_in_jax)
    return JaxLatentGraphs(monkeypatch)


def _random_tree(tree, seed):
    """Random parameters of the tree's shapes, biases included: the
    initialisation's zero biases put TITO's gates and max aggregation
    at exact ties, where two right implementations route a gradient to
    different edges, and Adam carries that on."""
    rng = np.random.default_rng(seed)

    def draw(a):
        shape = np.shape(a)
        scale = 1 / np.sqrt(shape[0]) if len(shape) == 2 else 0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, tree)


def _run_jax_example(filename, argv, monkeypatch, latent):
    """Run the JAX example's ``main`` with ``argv`` from random initial
    parameters (:func:`_random_tree`); returns its Trainer, those
    parameters and the loaders it fitted on.  The latent graphs of the
    initialisation are dropped from ``latent``."""
    spec = importlib.util.spec_from_file_location(
        "jax_example", os.path.join(JAX_EXAMPLES, filename))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    seen = {}

    class Recording(module.Trainer):
        def init(self, batch):
            state = super().init(batch)
            params = _random_tree(jax.device_get(state.params), 7)
            self.state = state = type(state)(
                params=params, opt_state=self.optimizer.init(params))
            seen.setdefault("params0", params)
            latent.graphs.clear()
            return state

        def fit(self, train_loader, val_loader=None, **kw):
            seen.update(trainer=self, train=train_loader, val=val_loader)
            return super().fit(train_loader, val_loader, **kw)

    monkeypatch.setattr(module, "Trainer", Recording)
    monkeypatch.setattr(sys, "argv", [filename] + argv)
    module.main()
    return seen


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_matches_the_jax_example(name, tmp_path, monkeypatch, capsys):
    """The port example and the JAX one, one epoch on the CPU with the
    same loader seed, from the same random initial parameters, on one
    graph (:func:`_one_graph`): the predictions within 1e-4.  Then the port example's own command line
    (``--device cpu``, its own initial weights) runs and prints."""
    filename, argv, which = EXAMPLES[name]
    argv = argv + ["--max-epochs", "1"]
    if name == "train_from_config":
        argv += ["--output", str(tmp_path / "jax")]
    latent = _one_graph(monkeypatch)
    seen = _run_jax_example(filename, argv, monkeypatch, latent)
    example = importlib.import_module(f"graphnet_tpu_torch.examples.{name}")
    if name == "train_from_config":
        argv[-1] = str(tmp_path / "port")
    args = example.parse_args(argv + ["--device", "cpu"])
    assert example.parse_args([]).device == "cuda"
    built = example.build(args)
    model = built[-1]
    model.load_state_dict(params_from_jax(seen["params0"], model.state_dict()))
    trained = example.train(args, *built)
    trainer = trained[0] if isinstance(trained, tuple) else trained
    loader = built[1] if which == "val" else built[0]
    got = np.concatenate(trainer.predict(loader), axis=1)
    exp = np.concatenate(seen["trainer"].predict(seen[which]), axis=1)
    assert got.shape == exp.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, exp, rtol=1e-4,
                               atol=1e-4 * float(np.abs(exp).max()))
    # the JAX example predicted once more, in its main
    assert latent.used > 0 or name != "train_from_config"
    if name == "train_from_config":
        for f in ("best", "last"):
            assert (tmp_path / "port" / f).exists()

    monkeypatch.undo()  # the port's own graphs from here on
    capsys.readouterr()
    out_dir = tmp_path / "cli"
    example.main(["--device", "cpu", "--max-epochs", "1"]
                 + (["--output", str(out_dir)]
                    if name == "train_from_config" else []))
    printed = capsys.readouterr().out
    assert ("final train loss" if name == "train_rnn_tito"
            else "rows x") in printed
    if name == "train_from_config":
        assert {"best", "last", "model.yml", "state_dict.pkl"} <= set(
            os.listdir(out_dir))


@pytest.mark.parametrize("name,argv", [
    ("materialize_and_replay", []),
    ("high_throughput_pipeline", ["--n-events", "24", "--batch-size", "4",
                                  "--max-epochs", "1", "--stack-k", "2",
                                  "--prefetch", "2"]),
])
def test_pipeline_example_runs_on_the_cpu(name, argv, tmp_path, monkeypatch,
                                          capsys):
    """The two input-pipeline examples' command lines (counterparts of
    ``01_data/06_materialize_and_replay.py`` and
    ``03_training/08_high_throughput_pipeline.py``) at a tiny size on the
    CPU, their temporary files in ``tmp_path``: they train and print the
    epochs' losses; the JAX examples' defaults; the GPU by default."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    example = importlib.import_module(f"graphnet_tpu_torch.examples.{name}")
    assert example.parse_args([]).device == "cuda"
    trainer = example.main(argv + ["--device", "cpu"])
    assert trainer.step > 0
    assert "train_loss per epoch" in capsys.readouterr().out
    if name == "high_throughput_pipeline":
        args = example.parse_args([])
        assert (args.batch_size, args.n_events, args.stack_k,
                args.prefetch) == (32, 512, 4, 4)
        assert trainer.steps_per_dispatch == 2
        assert os.path.exists(tmp_path / "graphnet_tpu_synth_prometheus_24_0.db")
    else:
        # the store's temporary directory was removed
        assert not [f for f in os.listdir(tmp_path) if f.startswith("tmp")]


# ------------------------------------------------------- data examples
DATA_EXAMPLES = {
    # port module: the JAX example under examples/
    "read_dataset": "01_data/01_read_dataset.py",
    "ensemble_dataset": "01_data/02_ensemble_dataset.py",
    "convert_parquet_to_sqlite": "01_data/03_convert_parquet_to_sqlite.py",
    "compare_sqlite_and_parquet": "01_data/04_compare_sqlite_and_parquet.py",
    "plot_feature_distributions": "01_data/05_plot_feature_distributions.py",
    "convert_h5": "04_liquido/01_convert_h5.py",
    "convert_prometheus": "05_prometheus/01_convert_prometheus.py",
}


def _jax_data_example(path):
    spec = importlib.util.spec_from_file_location(
        "jax_data_example",
        os.path.join(GRAPHNET_ROOT_DIR, "examples", path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", list(DATA_EXAMPLES))
def test_data_example_matches_the_jax_example(name, tmp_path, monkeypatch,
                                              capsys):
    """The data examples against the JAX ones on the CPU: what the
    readers print, line for line; the conversions' databases, exactly
    (``tests/test_torch_dataconverter.py``'s comparison); the plotted
    feature matrix, bit for bit the JAX dataset's, and both figures
    written."""
    import tempfile
    from pathlib import Path

    from tests.test_torch_dataconverter import assert_same_sqlite

    jax_example = _jax_data_example(DATA_EXAMPLES[name])
    example = importlib.import_module(f"graphnet_tpu_torch.examples.{name}")
    if name.startswith("convert"):
        (tmp_path / "jax").mkdir()
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "jax"))
        jax_example.main()
        (exp,) = [p for p in (tmp_path / "jax").iterdir()]
        got = Path(example.main(["--output", str(tmp_path / "port")]))
        if name == "convert_parquet_to_sqlite":
            got, exp = got.parent.parent, exp
        files = sorted(p.relative_to(exp) for p in exp.rglob("*.db"))
        assert files and files == sorted(p.relative_to(got)
                                         for p in got.rglob("*.db"))
        for f in files:
            assert_same_sqlite(got / f, exp / f)
    elif name == "plot_feature_distributions":
        from graphnet_tpu.utils.config import load_dataset as jax_load_dataset

        jax_example.main(str(tmp_path / "jax.png"))
        x = example.main(["--output", str(tmp_path / "port.png")])
        ds = jax_load_dataset(os.path.join(
            GRAPHNET_ROOT_DIR, "configs", "datasets",
            "training_example_data_sqlite.yml"))
        if isinstance(ds, dict):
            ds = sorted(ds.items())[0][1]
        exp = np.concatenate([np.asarray(ds[i].x) for i in range(len(ds))])
        np.testing.assert_array_equal(x, exp)
        for f in ("jax.png", "port.png"):
            assert (tmp_path / f).stat().st_size > 0
    else:
        capsys.readouterr()
        jax_example.main()
        exp = capsys.readouterr().out
        example.main()
        got = capsys.readouterr().out
        assert got == exp and got.strip()


# ----------------------------------------------------- IceTray examples
@pytest.mark.parametrize("name", ["convert_i3_files", "deploy_i3_modules"])
def test_icetray_example_without_icetray(name, capsys):
    """Without IceTray the two IceTray examples (counterparts of
    ``07_icetray/01_convert_i3_files.py`` and ``02_deploy_i3_modules.py``)
    say so and return; the deployment serves on the GPU by default, the
    conversion runs on the host and takes no device."""
    from graphnet_tpu_torch.utils.imports import has_icecube_package

    assert not has_icecube_package()
    example = importlib.import_module(f"graphnet_tpu_torch.examples.{name}")
    assert getattr(example.parse_args([]), "device", None) == (
        "cuda" if name == "deploy_i3_modules" else None)
    assert example.main([]) is None
    assert "icetray is not installed" in capsys.readouterr().out


def _standin_inputs(F, tmp_path, pulsemap):
    """A GCD file and a folder of two stand-in files (frames of 0-40
    pulses, the pulse map also as ``pulsemap``)."""
    rng = np.random.default_rng(2)
    gcd, keys = F.fake_gcd(rng, rng.normal(0.0, 150.0, (40, 3)))
    gcd_path = tmp_path / "gcd.i3.gz"
    F.write_i3(gcd_path, gcd)
    raw = tmp_path / "raw"
    raw.mkdir()
    for i, lengths in enumerate(((0, 12, 40), (7,))):
        frames = F.random_frames(rng, keys, lengths)
        for f in frames:
            if f.Stop == "P" and pulsemap != F.PULSEMAP:
                f[pulsemap] = f[F.PULSEMAP]
        F.write_i3(raw / f"run{i}.i3.gz", frames)
    return str(gcd_path), str(raw)


@pytest.mark.parametrize("backend", ["sqlite", "parquet"])
def test_convert_i3_example_on_the_standin(backend, tmp_path, icetray):
    from tests.test_torch_dataconverter import _files

    gcd, raw = _standin_inputs(icetray, tmp_path, "SRTInIcePulses")
    example = importlib.import_module(
        "graphnet_tpu_torch.examples.convert_i3_files")
    out = example.main([backend, "--input-dir", raw, "--gcd-rescue", gcd,
                        "--outdir", str(tmp_path / "out")])
    files = _files(out)
    assert any(f.startswith("merged") for f in files), files
    if backend == "sqlite":
        import sqlite3

        with sqlite3.connect(os.path.join(out, "merged", "merged.db")) as c:
            n = c.execute("SELECT COUNT(*) FROM SRTInIcePulses").fetchone()[0]
            events = c.execute("SELECT COUNT(*) FROM truth").fetchone()[0]
        assert (n, events) == (12 + 40 + 7, 4)


def test_deploy_i3_example_on_the_standin(tmp_path, icetray):
    """The deployment example on the stand-in with ``--device cpu``: the
    zoo's full-width QUESO energy model (weights saved by
    ``save_model``) writes an energy ``I3Double`` into every physics
    frame, NaN for the 0-pulse one."""
    example = importlib.import_module(
        "graphnet_tpu_torch.examples.deploy_i3_modules")
    model = config.load_model(os.path.join(example.ZOO_MODEL, "model.yml"),
                              device="cpu", seed=0)
    config.save_model(model, str(tmp_path / "model"))
    gcd, raw = _standin_inputs(icetray, tmp_path, icetray.PULSEMAP)
    written = example.main([
        "--input-dir", raw, "--gcd-file", gcd, "--device", "cpu",
        "--state-dict", str(tmp_path / "model" / "state_dict.pkl")])
    assert len(written) == 2
    values = [f["graphnet_tpu_deployment_example_energy"].value
              for path in written for f in icetray.read_i3(path)
              if f.Stop == "P"]
    assert len(values) == 4 and np.isnan(values[0])
    assert not np.isnan(values[1:]).any()
