"""The port's serving artifacts on the CPU: ``export_serving`` /
``ExportedModel`` against the JAX package's on the bundled SQLite events
and against the port's live ``DeploymentModule``; the JAX export tests'
contract (layout, padding, chunking, long events, empty events, feature
width); the kernel operators in the exported graphs of DynEdge (with
and without ``FUSE_CONV_KNN``), DynEdgeTITO and DeepIce; each of the ten
operators under ``torch.library.opcheck`` and against its plain version;
an artifact served in a fresh process that imports no model code; and
the deployment example's CLI."""

import json
import os
import pickle
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from graphnet_tpu.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu.data.constants import FEATURES, TRUTH
from graphnet_tpu.data.dataloader import DataLoader
from graphnet_tpu.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu.deployment.deployment_module import (
    DeploymentModule as JaxDeploymentModule,
)
from graphnet_tpu.deployment.export import ExportedModel as JaxExportedModel
from graphnet_tpu.models.detector.prometheus import Prometheus
from graphnet_tpu.models.gnn.dynedge import DynEdge as JaxDynEdge
from graphnet_tpu.models.graphs import KNNGraph
from graphnet_tpu.models.standard_model import StandardModel as JaxStandardModel
from graphnet_tpu.models.task.reconstruction import (
    EnergyReconstruction as JaxEnergy,
)
from graphnet_tpu.training.loss_functions import LogCoshLoss
from graphnet_tpu.training.trainer import Trainer as JaxTrainer
from graphnet_tpu.utils.config import TRANSFORM_REGISTRY, save_model_config
from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
from graphnet_tpu_torch.deployment.export import ExportedModel
from graphnet_tpu_torch.models.components import layers
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.gnn.dynedge_kaggle_tito import DynEdgeTITO
from graphnet_tpu_torch.models.gnn.icemix import DeepIce
from graphnet_tpu_torch.models.graphs.graph_definition import Event
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.models.task.reconstruction import (
    DirectionReconstructionWithKappa,
    EnergyReconstruction,
)
from graphnet_tpu_torch.ops import edgeconv_cuda as ec
from graphnet_tpu_torch.ops import flash_attention_cuda as fa
from graphnet_tpu_torch.ops import knn_cuda
from graphnet_tpu_torch.ops import rel_flash_attention as rp
from graphnet_tpu_torch.ops import rel_flash_attention_cuda as rc
from graphnet_tpu_torch.ops.knn import knn_graph_plain

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
OPS = torch.ops.graphnet_tpu_torch
FORWARD_OPS = ("knn_graph", "edgeconv_fwd", "edgeconv_knn_fwd", "flash_fwd",
               "rel_fwd")
BACKWARD_OPS = ("edgeconv_bwd", "flash_bwd_dq", "flash_bwd_dkv", "rel_bwd_dq",
                "rel_bwd_dkv")
# the JAX export tests' tolerance, between the packages
RTOL, ATOL = 2e-4, 1e-5
GRID = dict(batch_sizes=(1, 4), lengths=(64, 128))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A narrow JAX DynEdge energy model saved as ``model.yml`` +
    ``state_dict.pkl``, exported by both packages' ``DeploymentModule``
    on the same grid; the bundled events in both packages' types."""
    tmp = tmp_path_factory.mktemp("export")
    ds = SQLiteDataset(
        path=EXAMPLE_SQLITE_DATA,
        graph_definition=KNNGraph(detector=Prometheus()),
        pulsemaps="total",
        features=FEATURES.PROMETHEUS,
        truth=TRUTH.PROMETHEUS,
        truth_table="mc_truth",
    )
    jmodel = JaxStandardModel(
        backbone=JaxDynEdge(nb_inputs=4, dynedge_layer_sizes=((8, 8),)),
        tasks=(JaxEnergy(
            loss_function=LogCoshLoss(),
            target_labels=("total_energy",),
            transform_prediction_and_target=TRANSFORM_REGISTRY["log10"],
        ),),
    )
    trainer = JaxTrainer(jmodel)
    trainer.init(next(iter(DataLoader(ds, batch_size=8, shuffle=False))))
    yml, pkl = str(tmp / "model.yml"), str(tmp / "state_dict.pkl")
    save_model_config(jmodel, yml)
    trainer.save_state_dict(pkl)
    jmodule = JaxDeploymentModule(yml, pkl)
    jdir = str(tmp / "jax_serving")
    jmodule.export_serving(jdir, **GRID)
    module = DeploymentModule(yml, pkl, device="cpu")
    pdir = str(tmp / "serving")
    meta = module.export_serving(pdir, **GRID)
    jevents = [e for e in ds.get_events(list(range(12))) if e.n_pulses >= 1]
    events = [Event(x=e.x, features=list(e.features)) for e in jevents]
    return dict(module=module, dir=pdir, meta=meta, events=events,
                jdir=jdir, jevents=jevents)


def test_artifact_matches_jax_artifact_and_live_module(artifacts):
    """The same events through the JAX artifact and the port's: within
    the JAX export tests' tolerance; the port's artifact against the
    port's live module within 1e-6."""
    a = artifacts
    served = ExportedModel(a["dir"])
    got = served(a["events"])
    exp = JaxExportedModel(a["jdir"])(a["jevents"])
    assert got.shape == exp.shape == (len(a["events"]), 1)
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, a["module"](a["events"]), rtol=1e-6,
                               atol=0.0)


def test_artifact_layout(artifacts):
    meta, pdir = artifacts["meta"], artifacts["dir"]
    assert meta["prediction_columns"] == ["energy_pred"]
    assert meta["device"] == "cpu" and meta["dtype"] == "float32"
    assert meta["nb_inputs"] == 4 and meta["version"] == 1
    assert len(meta["shapes"]) == 4  # 2 batch sizes x 2 lengths
    for s in meta["shapes"]:
        assert s["file"] == f"b{s['batch']:04d}_l{s['length']:05d}.pt2"
        assert os.path.exists(os.path.join(pdir, s["file"]))
    with open(os.path.join(pdir, "serving.json")) as f:
        assert json.load(f) == meta


def test_matches_live_module(artifacts):
    module, events = artifacts["module"], artifacts["events"]
    served = ExportedModel(artifacts["dir"])
    assert served.prediction_columns == module.prediction_columns
    assert served.device == torch.device("cpu")
    live, aot = module(events[:4]), served(events[:4])
    assert aot.shape == live.shape
    np.testing.assert_allclose(aot, live, rtol=RTOL, atol=ATOL)


def test_single_event_and_padding(artifacts):
    module, events = artifacts["module"], artifacts["events"]
    served = ExportedModel(artifacts["dir"])
    np.testing.assert_allclose(served(events[0]), module(events[0]),
                               rtol=RTOL, atol=ATOL)
    # 3 events pad to the B=4 program; rows match one at a time
    three = served(events[:3])
    assert three.shape == (3, 1)
    singles = np.concatenate([served(e) for e in events[:3]])
    np.testing.assert_allclose(three, singles, rtol=RTOL, atol=ATOL)


def test_chunking_beyond_largest_batch(artifacts):
    module, events = artifacts["module"], artifacts["events"]
    served = ExportedModel(artifacts["dir"])
    n = min(10, len(events))  # > the largest exported batch (4)
    out = served(events[:n])
    assert out.shape == (n, 1)
    np.testing.assert_allclose(out, module(events[:n]), rtol=RTOL, atol=ATOL)


def test_long_event_guard_and_optin_truncation(artifacts):
    """Events beyond the exported lengths raise (the live module would
    use more pulses); ``truncate_long=True`` serves the first L."""
    events = artifacts["events"]
    rng = np.random.default_rng(0)
    long_ev = Event(x=rng.standard_normal((200, 4)).astype(np.float32),
                    features=list(events[0].features))
    with pytest.raises(ValueError, match="exceeds the largest"):
        ExportedModel(artifacts["dir"])(long_ev)
    lax = ExportedModel(artifacts["dir"], truncate_long=True)
    truncated = Event(x=long_ev.x[:128], features=list(long_ev.features))
    np.testing.assert_allclose(lax(long_ev), lax(truncated), rtol=RTOL,
                               atol=ATOL)


def test_empty_event_rows_stay_aligned(artifacts):
    """0-pulse events give NaN rows; the other rows keep their places
    (live module and artifact)."""
    module, events = artifacts["module"], artifacts["events"]
    empty = Event(x=np.zeros((0, 4), np.float32),
                  features=list(events[0].features))
    req = [events[0], empty, events[1]]
    for impl in (module, ExportedModel(artifacts["dir"])):
        out = impl(req)
        assert out.shape == (3, 1) and np.isnan(out[1, 0])
        singles = np.concatenate([impl(events[0]), impl(events[1])])
        np.testing.assert_allclose(out[[0, 2]], singles, rtol=RTOL,
                                   atol=ATOL)


def test_feature_width_guard(artifacts):
    bad = Event(x=np.zeros((5, 7), np.float32),
                features=[f"f{i}" for i in range(7)])
    with pytest.raises(ValueError, match="nb_inputs"):
        ExportedModel(artifacts["dir"])(bad)


def test_artifact_of_another_device_raises(artifacts, tmp_path, monkeypatch):
    """A CUDA artifact never runs on the CPU: where the card is missing
    ``ExportedModel`` raises; a model on another device than the one
    asked for is not exported."""
    meta = dict(artifacts["meta"], device="cuda")
    (tmp_path / "serving.json").write_text(json.dumps(meta))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExportedModel(str(tmp_path))
    from graphnet_tpu_torch.deployment.export import export_serving

    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_serving(artifacts["module"].model, str(tmp_path / "x"), 4,
                       ["energy_pred"], device="cuda")


# ------------------------------------------------- operators in the graph
def _op_nodes(program):
    """Counts of the port's operators among the exported graph's nodes."""
    return Counter(
        node.target.name().split("::")[1].split(".")[0]
        for node in program.graph.nodes
        if node.op == "call_function"
        and isinstance(node.target, torch._ops.OpOverload)
        and node.target.namespace == "graphnet_tpu_torch")


def _exported_ops(model, tmp_path, nb_inputs, L, rng):
    """Export ``model`` at (B=2, L) on the CPU: the operator counts of the
    graph saved, and the loaded program's answers against the live
    module's on two events, bit for bit."""
    module = DeploymentModule(model, model.state_dict(), device="cpu")
    module.export_serving(str(tmp_path), nb_inputs=nb_inputs, batch_sizes=(2,),
                          lengths=(L,))
    program = torch.export.load(str(tmp_path / f"b0002_l{L:05d}.pt2"))
    served = ExportedModel(str(tmp_path))
    events = [Event(x=rng.standard_normal((n, nb_inputs)).astype(np.float32),
                    features=[f"f{i}" for i in range(nb_inputs)])
              for n in (L // 2, L - 3)]
    np.testing.assert_array_equal(served(events), module(events))
    return _op_nodes(program)


NARROW_DYNEDGE = dict(dynedge_layer_sizes=((16, 24), (24, 24), (24, 24),
                                           (24, 24)),
                      post_processing_layer_sizes=(24, 16),
                      readout_layer_sizes=(8,))


def _dynedge():
    return StandardModel(DynEdge(nb_inputs=4, **NARROW_DYNEDGE),
                         [EnergyReconstruction(hidden_size=8)], device="cpu")


def test_dynedge_graph_holds_knn_and_edgeconv_operators(tmp_path):
    ops = _exported_ops(_dynedge(), tmp_path, 4, 64,
                        np.random.default_rng(1))
    assert ops == {"knn_graph": 5, "edgeconv_fwd": 4}


def test_fused_dynedge_graph_holds_one_knn_and_four_row4_operators(
        tmp_path, monkeypatch):
    monkeypatch.setattr(layers, "FUSE_CONV_KNN", True)
    ops = _exported_ops(_dynedge(), tmp_path, 4, 128,
                        np.random.default_rng(2))
    assert ops == {"knn_graph": 1, "edgeconv_knn_fwd": 4}


def test_tito_graph_holds_knn_edgeconv_and_flash_operators(tmp_path):
    model = StandardModel(
        DynEdgeTITO(nb_inputs=4, dyntrans_layer_sizes=((64, 64), (64, 64)),
                    n_head=2, post_processing_layer_sizes=(48, 32),
                    readout_layer_sizes=(32, 16)),
        [DirectionReconstructionWithKappa(hidden_size=16)], device="cpu")
    ops = _exported_ops(model, tmp_path, 4, 64, np.random.default_rng(3))
    assert ops == {"knn_graph": 1, "edgeconv_fwd": 2, "flash_fwd": 2}


def test_deepice_graph_holds_rel_and_flash_operators(tmp_path):
    model = StandardModel(
        DeepIce(hidden_dim=64, head_size=32, seq_length=16, depth=1,
                depth_rel=2),
        [DirectionReconstructionWithKappa(hidden_size=64)], device="cpu")
    ops = _exported_ops(model, tmp_path, 6, 32, np.random.default_rng(4))
    # depth_rel=2: the first BlockRel on the rel kernel, the second on
    # flash attention; depth=1 Block on flash with the cls key
    assert ops == {"rel_fwd": 1, "flash_fwd": 2}
    assert not set(ops) & set(BACKWARD_OPS)


# ------------------------------------------------------ the ten operators
def _leaves(rng, *shapes, dtype=torch.float32):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in shapes]


def _op_case(name):
    """``(inputs, plain outputs)`` of operator ``name`` at a small shape;
    the float inputs a forward differentiates require grad."""
    rng = np.random.default_rng(len(name))
    B, L, k, H1, H2 = 2, 16, 4, 12, 10
    idx = torch.from_numpy(rng.integers(0, L, (B, L, k)).astype(np.int32))
    em = torch.from_numpy(rng.random((B, L, k)) > 0.3)
    nmask = torch.from_numpy(rng.random((B, L)) > 0.2)
    a, b, w2, b2, g = _leaves(rng, (B, L, H1), (B, L, H1), (H1, H2), (H2,),
                              (B, L, H2))
    H, hd = 3, 16
    q, k_, v, go = _leaves(rng, *[(B, H, L, hd)] * 4)
    w, bias = _leaves(rng, (hd, hd), (hd,))
    x0 = torch.from_numpy(rng.standard_normal((B, L, 4)).astype(np.float32))
    qt, qb = q @ w, q @ bias
    if name == "knn_graph":
        x = torch.from_numpy(rng.standard_normal((B, L, 7)).astype(np.float32))
        args = (x[..., 1:4], nmask, 5, True)  # a strided view, as served
        return args, knn_graph_plain(*args)
    if name.startswith("edgeconv"):
        if name == "edgeconv_fwd":
            args = (a, b, idx, em, w2, b2, "max", 0.01)
            plain = ec.fused_edgeconv_plain(*args)
        elif name == "edgeconv_knn_fwd":
            args = (a, b, idx, em, nmask, w2, b2, "add", 0.0, 4, 0, 3)
            plain = ec.fused_edgeconv_knn_plain(*args)
        else:
            args = (a, b, idx, em, w2, b2, g, "max", 0.0)
            plain = ec.fused_edgeconv_bwd_plain(*args)
        return args, plain
    if name.startswith("flash"):
        q, k_, v, go = _leaves(rng, *[(B, H, L, 32)] * 4)
        o, lse = fa.flash_attention_plain(q, k_, v, nmask)
        if name == "flash_fwd":
            return (q, k_, v, nmask, None), (o, lse)
        delta = fa.attention_delta(go, o)
        args = (q, k_, v, nmask, lse, go, delta, 0.5)
        plain = fa._bwd_plain(q, k_, v, nmask, lse, go, delta, 0.5)
        return args, (plain[0] if name == "flash_bwd_dq" else plain[1:])
    core = (q, qt, qb, k_, v, x0, nmask)
    o, oe, lse = rp.rel_attention_plain(*core)
    if name == "rel_fwd":
        return core, (o, oe, lse)
    goe = _leaves(rng, (B, H, L, hd))[0]
    args = core + (lse, go, goe, rp.rel_attention_delta(go, o, goe, oe))
    plain = rp.rel_attention_bwd_plain(*args)
    return args, (plain[:3] if name == "rel_bwd_dq" else plain[3:])


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", FORWARD_OPS + BACKWARD_OPS)
def test_operator_opcheck_and_plain_version(name):
    """``torch.library.opcheck`` of each operator on the CPU (its schema,
    fake implementation and autograd registration), and the CPU
    implementation bit-equal to the plain version.

    The operators have no autograd formula (the forward's
    ``torch.autograd.Function`` calls the backward operators; its
    gradients are tested against the JAX package in the model tests), so
    ``test_autograd_registration`` runs with inputs that require grad
    (it checks that no output then requires grad) and
    ``test_aot_dispatch_dynamic``, which would differentiate the
    operator, with inputs that do not."""
    op = getattr(OPS, name).default
    args, plain = _op_case(name)
    grads = tuple(t.detach().requires_grad_(True)
                  if isinstance(t, torch.Tensor) and t.is_floating_point()
                  else t for t in args)
    torch.library.opcheck(op, grads, test_utils=(
        "test_schema", "test_autograd_registration", "test_faketensor"))
    torch.library.opcheck(op, args, test_utils=(
        "test_schema", "test_faketensor", "test_aot_dispatch_dynamic"))
    got = _as_tuple(op(*args))
    for t, p in zip(got, _as_tuple(plain), strict=True):
        assert t.dtype == p.dtype and t.shape == p.shape
        assert torch.equal(t, p)


def test_every_kernel_is_an_operator_with_cuda_cpu_and_fake_kernels():
    for name in FORWARD_OPS + BACKWARD_OPS:
        qual = f"graphnet_tpu_torch::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), (
                name, key)


def test_cuda_implementations_never_take_the_plain_version(monkeypatch):
    """The CUDA implementation of an operator checks its tensors and
    raises on one that is not on the card: it never calls the plain
    version, whose calls are counted here."""
    cases = {name: _op_case(name)[0] for name in FORWARD_OPS}
    calls = []
    monkeypatch.setattr(knn_cuda, "knn_graph_plain",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(ec, "fused_edgeconv_plain", lambda *a: calls.append(a))
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(rc, "rel_attention_plain", lambda *a: calls.append(a))
    for name, impl in (("knn_graph", knn_cuda._knn_cuda),
                       ("edgeconv_fwd", ec._fwd_cuda),
                       ("flash_fwd", fa._fwd_cuda),
                       ("rel_fwd", rc._fwd_cuda)):
        with pytest.raises(ValueError, match="CUDA"):
            impl(*cases[name])
    assert calls == []


# ------------------------------------------------------ a fresh process
def test_artifact_served_in_a_process_without_model_code(artifacts):
    """A process that imports only ``graphnet_tpu_torch.deployment.
    export`` (no JAX, no backbone) loads the artifact and gives this
    process's answers bit for bit."""
    events = artifacts["events"][:6]
    npz = Path(artifacts["dir"]).parent / "events.npz"
    np.savez(npz, *[e.x for e in events])
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "flax", "graphnet_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from graphnet_tpu_torch.deployment.export import ExportedModel
        from graphnet_tpu_torch.models.graphs.graph_definition import Event
        data = np.load({str(npz)!r})
        events = [Event(x=data[f"arr_{{i}}"], features={FEATURES.PROMETHEUS!r})
                  for i in range(len(data.files))]
        out = ExportedModel({artifacts["dir"]!r})(events)
        assert "graphnet_tpu_torch.models.gnn" not in sys.modules
        assert "graphnet_tpu_torch.models.standard_model" not in sys.modules
        np.save(sys.stdout.buffer, out)
    """)
    done = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          cwd=ROOT, timeout=300)
    assert done.returncode == 0, done.stderr.decode()[-3000:]
    import io

    got = np.load(io.BytesIO(done.stdout))
    np.testing.assert_array_equal(got, ExportedModel(artifacts["dir"])(events))
    assert np.isfinite(got).all()


# ---------------------------------------------------------- the example
def test_deploy_example_on_the_cpu(tmp_path, capsys):
    """``python -m graphnet_tpu_torch.examples.deploy_model --device cpu``
    on a narrow DynEdge saved as ``model.yml`` + ``state_dict.pkl``: it
    serves the bundled events live and from the artifact it exports, and
    prints the largest difference."""
    from graphnet_tpu_torch.examples import deploy_model
    from graphnet_tpu_torch.utils import config
    from graphnet_tpu_torch.utils.jax_params import params_to_jax

    model = StandardModel(
        DynEdge(nb_inputs=4, **NARROW_DYNEDGE),
        [EnergyReconstruction(
            hidden_size=8, target_labels=("total_energy",),
            transform_prediction_and_target=config.TRANSFORM_REGISTRY[
                "log10"])],
        device="cpu")
    config.save_model_config(model, str(tmp_path / "model.yml"))
    with open(tmp_path / "state_dict.pkl", "wb") as f:
        pickle.dump(params_to_jax(model.state_dict()), f)
    assert deploy_model.parse_args([]).device == "cuda"
    diff = deploy_model.main(["--device", "cpu", "--model-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "predicted energy" in printed and "max |diff|" in printed
    assert diff <= 1e-6
    meta = json.loads((tmp_path / "serving" / "serving.json").read_text())
    assert meta["device"] == "cpu"
