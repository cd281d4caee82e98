"""The port stands alone: it imports no JAX, no flax and nothing of the
JAX package (serving and a training step, of DynEdge, of TITO and of
DeepIce, run without them), nothing builds a kernel at import time or on
the CPU, no module starts a compiler when it is imported, and its entry
points default to the GPU."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "graphnet_tpu")


def _port_files():
    return sorted((ROOT / "graphnet_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_top_level_name_defined_twice(path):
    """A second ``def`` of a module-level name silently replaces the
    first for every caller, those written against the first too."""
    tree = ast.parse(path.read_text(), filename=str(path))
    seen, twice = set(), []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name in seen:
                twice.append(node.name)
            seen.add(node.name)
    assert not twice, f"{path.relative_to(ROOT)} defines {twice} twice"


def test_port_imports_and_runs_without_jax():
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        for name in ("jax", "flax", "graphnet_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import numpy as np
        import torch
        torch.set_num_threads(2)
        import graphnet_tpu_torch
        from graphnet_tpu_torch.kernels import build
        def no_build(*args, **kwargs):
            raise AssertionError("a kernel was built")
        build.build = build.load = no_build
        for mod in pkgutil.walk_packages(
            graphnet_tpu_torch.__path__, "graphnet_tpu_torch."
        ):
            importlib.import_module(mod.name)
        from graphnet_tpu_torch.deployment.deployment_module import (
            DeploymentModule,
        )
        from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
        from graphnet_tpu_torch.models.graphs.graph_definition import Event
        from graphnet_tpu_torch.models.standard_model import StandardModel
        from graphnet_tpu_torch.models.task.reconstruction import (
            EnergyReconstruction,
        )
        model = StandardModel(
            DynEdge(nb_inputs=4, dynedge_layer_sizes=((16, 32),),
                    post_processing_layer_sizes=(16,),
                    readout_layer_sizes=(8,)),
            [EnergyReconstruction(hidden_size=8)], device="cpu",
        )
        module = DeploymentModule(model, model.state_dict(), device="cpu")
        rng = np.random.default_rng(0)
        events = [Event(x=rng.standard_normal((n, 4)).astype(np.float32),
                        features=list("xyzt")) for n in (9, 3)]
        out = module(events)
        assert out.shape == (2, 1) and np.isfinite(out).all(), out
        # one training step on the CPU
        from graphnet_tpu_torch.batch import make_batch
        from graphnet_tpu_torch.training.loss_functions import LogCoshLoss
        from graphnet_tpu_torch.training.trainer import Trainer
        model.tasks_0.loss_function = LogCoshLoss()
        model.tasks_0.target_labels = ("total_energy",)
        model.tasks_0.transform_prediction_and_target = torch.log10
        batch = make_batch([e.x for e in events],
                           labels={"total_energy": np.array([10.0, 300.0])})
        trainer = Trainer(model)
        before = [p.detach().clone() for p in model.parameters()]
        loss = trainer.train_step(batch)
        assert torch.isfinite(loss) and trainer.step == 1
        assert all(p.grad is not None for p in model.parameters())
        assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
        # TITO direction: serving and a training step
        from graphnet_tpu_torch.models.gnn.dynedge_kaggle_tito import DynEdgeTITO
        from graphnet_tpu_torch.models.task.reconstruction import (
            DirectionReconstructionWithKappa,
        )
        from graphnet_tpu_torch.training.loss_functions import (
            VonMisesFisher3DLoss,
        )
        tito = StandardModel(
            DynEdgeTITO(nb_inputs=4, dyntrans_layer_sizes=((32, 32),),
                        n_head=1, post_processing_layer_sizes=(16,),
                        readout_layer_sizes=(8,)),
            [DirectionReconstructionWithKappa(
                hidden_size=8, loss_function=VonMisesFisher3DLoss())],
            device="cpu",
        )
        out = DeploymentModule(tito, tito.state_dict(), device="cpu")(events)
        assert out.shape == (2, 4) and np.isfinite(out).all(), out
        batch = make_batch([e.x for e in events],
                           labels={"direction": np.eye(3, dtype=np.float32)[:2]})
        loss = Trainer(tito).train_step(batch)
        assert torch.isfinite(loss)
        assert all(p.grad is not None for p in tito.parameters())
        # DeepIce direction: serving and a training step (the rel
        # attention's plain versions on the CPU)
        from graphnet_tpu_torch.models.gnn.icemix import DeepIce
        ice = StandardModel(
            DeepIce(hidden_dim=32, head_size=16, seq_length=16, depth=1,
                    depth_rel=2),
            [DirectionReconstructionWithKappa(
                hidden_size=32, loss_function=VonMisesFisher3DLoss())],
            device="cpu",
        )
        ice_events = [Event(x=rng.random((n, 6)).astype(np.float32),
                            features=list("xyztca")) for n in (9, 0, 1)]
        out = DeploymentModule(ice, ice.state_dict(), device="cpu")(ice_events)
        assert out.shape == (3, 4) and np.isnan(out[1]).all(), out
        assert np.isfinite(out[[0, 2]]).all(), out
        batch = make_batch([e.x for e in ice_events],
                           labels={"direction": np.eye(3, dtype=np.float32)})
        loss = Trainer(ice).train_step(batch)
        assert torch.isfinite(loss)
        assert all(p.grad is not None for p in ice.parameters())
        assert not any(
            m == "jax" or m.startswith(("jax.", "flax", "graphnet_tpu."))
            for m in sys.modules if sys.modules[m] is not None
        )
        print("ok")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", script],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_nothing_compiles_at_import():
    """Importing every module of the port (the input pipeline's too:
    ``native``, the datasets, the store and the prefetching loaders) runs
    no compiler: ``graphnet_tpu_torch.native`` builds its host libraries
    at their first call only."""
    script = textwrap.dedent(
        """
        import importlib, pkgutil, subprocess, sys
        for name in ("jax", "flax", "graphnet_tpu"):
            sys.modules[name] = None
        def no_compiler(*args, **kwargs):
            raise AssertionError(f"a process was started: {args}")
        subprocess.run = subprocess.Popen = no_compiler
        import graphnet_tpu_torch
        for mod in pkgutil.walk_packages(
            graphnet_tpu_torch.__path__, "graphnet_tpu_torch."
        ):
            importlib.import_module(mod.name)
        from graphnet_tpu_torch import native
        assert native._libs == {}, native._libs
        for name in ("data.prefetch", "data.materialized", "data.samplers",
                     "data.parquet_dataset", "datasets.synthetic",
                     "training.utils", "examples.materialize_and_replay",
                     "examples.high_throughput_pipeline"):
            assert "graphnet_tpu_torch." + name in sys.modules, name
        assert "pyarrow" not in sys.modules
        print("ok")
        """
    )
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_entry_points_default_to_the_gpu():
    from graphnet_tpu_torch.deployment.deployment_module import (
        DeploymentModule,
    )
    from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import (
        EnergyReconstruction,
    )

    def build(**kw):
        return StandardModel(
            DynEdge(nb_inputs=4, dynedge_layer_sizes=((16, 32),),
                    post_processing_layer_sizes=(16,),
                    readout_layer_sizes=(8,)),
            [EnergyReconstruction(hidden_size=8)],
            **kw,
        )

    from graphnet_tpu_torch.data.extractors.icecube import (
        I3FeatureExtractorIceCubeUpgrade,
    )
    from graphnet_tpu_torch.deployment.icecube import (
        I3Deployer,
        I3InferenceModule,
        I3PulseCleanerModule,
    )

    model = build(device="cpu")

    def i3_modules(**kw):
        common = dict(model_config=model, state_dict=model.state_dict(),
                      gcd_file="gcd.i3.gz", **kw)
        extractor = I3FeatureExtractorIceCubeUpgrade("SplitInIcePulses")
        return [I3InferenceModule(pulsemap_extractor=extractor, **common),
                I3PulseCleanerModule(pulsemap="SplitInIcePulses",
                                     pulsemap_extractor=extractor, **common)]

    cpu = i3_modules(device="cpu")
    deployer = I3Deployer(cpu, gcd_file="gcd.i3.gz", n_workers=2)
    assert [m.device.type for m in deployer._modules] == ["cpu", "cpu"]
    if torch.cuda.is_available():
        assert DeploymentModule(model, model.state_dict()).device.type == "cuda"
        assert next(build().parameters()).device.type == "cuda"
        assert [m.device.type for m in I3Deployer(
            i3_modules(), "gcd.i3.gz")._modules] == ["cuda", "cuda"]
        model.to("cpu")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeploymentModule(model, model.state_dict())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        for cls in (I3InferenceModule, I3PulseCleanerModule):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                I3Deployer([cls(
                    pulsemap_extractor=I3FeatureExtractorIceCubeUpgrade("P"),
                    model_config=model, state_dict=model.state_dict(),
                    gcd_file="gcd.i3.gz",
                    **({"pulsemap": "P"} if cls is I3PulseCleanerModule
                       else {}))], "gcd.i3.gz")
        # the model was left where it was
        assert np.all([p.device.type == "cpu" for p in model.parameters()])


def test_data_modules_import_without_pandas_pyarrow_h5py():
    """As on the GPU host, which has no pandas: with pandas, pyarrow and
    h5py blocked (and JAX), every module of the port's ``data``,
    ``datasets``, ``utils`` and ``examples`` imports; the curated
    ``TestDataset`` reads the bundled SQLite database into batches; a
    conversion asks for pandas only when it runs."""
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        for name in ("jax", "flax", "graphnet_tpu", "pandas", "pyarrow",
                     "h5py"):
            sys.modules[name] = None
        import graphnet_tpu_torch
        names = []
        for sub in ("data", "datasets", "utils", "examples"):
            pkg = importlib.import_module("graphnet_tpu_torch." + sub)
            for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
                importlib.import_module(mod.name)
                names.append(mod.name)
        for name in ("data.dataconverter", "data.pre_configured",
                     "data.sqlite_utilities", "data.curated_datamodule",
                     "data.extractors.liquido", "data.readers.prometheus_reader",
                     "data.writers.parquet_writer", "datasets.test_dataset",
                     "datasets.prometheus_datasets", "utils.logging",
                     "utils.imports", "utils.maths",
                     "examples.convert_prometheus", "examples.convert_h5",
                     "examples.plot_feature_distributions"):
            assert "graphnet_tpu_torch." + name in names, name
        from graphnet_tpu_torch.datasets import TestDataset
        from graphnet_tpu_torch.models.detector.prometheus import Prometheus
        from graphnet_tpu_torch.models.graphs import KNNGraph
        ds = TestDataset(KNNGraph(detector=Prometheus()),
                         train_dataloader_kwargs={"batch_size": 8})
        batch = next(iter(ds.train_dataloader()))
        assert batch.batch_size == 8
        from graphnet_tpu_torch.data import sqlite_utilities as su
        from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
        assert len(su.get_event_numbers(EXAMPLE_SQLITE_DATA, "mc_truth")) == 50
        from graphnet_tpu_torch.utils.imports import has_torch_package
        assert has_torch_package()
        import tempfile
        from graphnet_tpu_torch.examples import convert_prometheus
        with tempfile.TemporaryDirectory() as out:
            try:
                convert_prometheus.main(["--output", out])
            except ImportError as e:
                assert "pandas" in str(e), e
            else:
                raise AssertionError("converted without pandas")
        print("ok")
        """
    )
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
