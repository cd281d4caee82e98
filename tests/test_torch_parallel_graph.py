"""The port's node-axis sharding and the Trainer's multi-process paths
against the port's one-process runs and the JAX package, on the CPU.

Two processes (gloo) on a ``(data, graph)`` mesh split each event's
nodes: one DynEdge training step at narrow widths (and at a longer L),
held against the one-process step (loss rtol 1e-4, gradients and
parameters rtol 5e-4, atol 1e-5, the input kNN graph bit for bit) and
against the JAX Trainer on a 2-device ``(data, graph)`` mesh with its
graph hints, after the two packages' one-device steps on the same
inputs (``assert_step_matches``: each gradient also within 5e-4 of its
leaf's largest, each parameter within its gradient's difference times
Adam's first-step slope; every kNN of the JAX model by the port's rule,
whose ties the random model's ReLU latents hold).  ``tests/tools_torch_parallel.py`` runs the rest in two
processes: ``fit`` over ``MaterializedLoader`` process shards with
validation in lockstep, ``predict`` returning each process's rows,
checkpoint resume (replicated and FSDP, rtol 1e-6 against an unbroken
run), dropout masks drawn as rows of the global batch's and gradient
clipping under FSDP.  The dry run's kernel audit and its graph shape
are checked on the graph runs.  Row 1's
plain version at k > 32 is held against the JAX package's XLA kNN.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from graphnet_tpu.ops.knn import knn_graph as jax_knn_graph
from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.data.materialized import materialize
from graphnet_tpu_torch.ops.knn import knn_graph
from graphnet_tpu_torch.parallel import dryrun
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.jax_params import params_to_jax
from tests.tools_torch_parallel import dropout_model
from tests.tools_torch_parallel_jax import (
    assert_step_matches,
    in_port_names,
    jax_batch,
    mesh_step,
    one_device_step,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_LOSS_RTOL, LOSS_RTOL, RESUME_RTOL = 1e-4, 1e-5, 1e-6
RTOL, ATOL = 5e-4, 1e-5
LONG_L = 128
GRAPH_LAYOUTS = ("graph", "graph_long")
SCENARIOS = ("fit_shards", "predict_rows", "resume_replicated", "resume_fsdp",
             "dropout_dp", "clip_fsdp")


def _model(kind="dynedge"):
    return dryrun.build_model(kind, "cpu", "narrow")


def _assert_close(got, exp, what, rtol=RTOL, atol=ATOL):
    for name, e in exp.items():
        np.testing.assert_allclose(
            got[name].detach().numpy(),
            e.detach().numpy() if torch.is_tensor(e) else np.asarray(e),
            rtol=rtol, atol=atol, err_msg=f"{what} {name}")


# ------------------------------------------------------- node sharding
@pytest.fixture(scope="module")
def graph_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("graph"))
    reports = dryrun.launch(2, "cpu", ",".join(GRAPH_LAYOUTS), width="narrow",
                            long_l=LONG_L, timeout=300, threads=1, out=out,
                            audit_kernels=True)
    return {r["layout"]: r for r in reports}, out


def _graph_inputs(layout):
    spec = dryrun.layout_spec(layout, 2, LONG_L)
    seed = 3 if layout == "graph_long" else 0
    return spec, dryrun.example_batch(spec["B"], spec["L"], seed=seed)


@pytest.mark.parametrize("layout", GRAPH_LAYOUTS)
def test_graph_step_matches_single_process(graph_runs, layout):
    """Each event's nodes split over two processes: the loss, gradients
    and parameters after one step equal the one-process step's."""
    reports, out = graph_runs
    report = reports[layout]
    assert report["mesh"] == {"data": 1, "graph": 2} and report["ok"]
    assert report["params_entries_beyond_tol"] == 0
    saved = torch.load(os.path.join(out, f"{layout}.pt"))
    spec, batch = _graph_inputs(layout)
    model = _model()
    loss = float(Trainer(model).train_step(batch))
    np.testing.assert_allclose(saved["loss"], loss, rtol=GRAPH_LOSS_RTOL)
    _assert_close(saved["grads"], {n: p.grad for n, p in model.named_parameters()},
                  "grad")
    _assert_close(saved["params"], model.state_dict(), "param")


@pytest.mark.parametrize("layout", GRAPH_LAYOUTS)
def test_graph_step_matches_jax_graph_mesh(graph_runs, layout):
    """The same step against the JAX Trainer on a 2-device ``(data,
    graph)`` mesh (``shard_batch_nodes`` and its graph hints); first the
    port's one-process step against the JAX Trainer's one-device step on
    these inputs."""
    _, out = graph_runs
    saved = torch.load(os.path.join(out, f"{layout}.pt"))
    spec, batch = _graph_inputs(layout)
    model = _model()
    tree = params_to_jax(model.state_dict())
    expected = model.state_dict()

    jax_one = in_port_names(one_device_step("dynedge", tree, batch), expected)
    jax_layout = in_port_names(mesh_step("dynedge", spec, tree, batch), expected)
    ref_loss = float(Trainer(model).train_step(batch))
    assert_step_matches(
        (ref_loss, {n: p.grad for n, p in model.named_parameters()},
         model.state_dict()), jax_one, "one device", LOSS_RTOL, RTOL, ATOL)
    assert_step_matches((saved["loss"], saved["grads"], saved["params"]),
                        jax_layout, layout, GRAPH_LOSS_RTOL, RTOL, ATOL)


@pytest.mark.parametrize("layout", GRAPH_LAYOUTS)
def test_graph_neighbours_are_the_unsharded_events(graph_runs, layout):
    """The kNN of each process's rows is the unsharded event's, bit for
    bit (the input graph; here the latent graphs too), and every
    process builds every layer's graph."""
    reports, _ = graph_runs
    report = reports[layout]
    assert report["input_graph_equal"]
    assert report["latent_rows_differing"] == 0
    assert report["graph_calls_per_rank"] == [3, 3]


@pytest.mark.parametrize("layout", GRAPH_LAYOUTS)
def test_kernel_audit_holds_every_call(graph_runs, layout):
    """``--audit-kernels``: each process's step and the one-process step
    hold every call of rows 2 and 3 (one a conv) against its plain
    version; on the CPU the operators run that plain version, so every
    error is 0, and each row-3 entry names a node of a real event."""
    reports, _ = graph_runs
    report = reports[layout]
    audits = report["kernel_audit_per_rank"] + [report["kernel_audit_one_process"]]
    for audit in audits:
        assert len(audit["edgeconv"]) == len(audit["edgeconv_bwd"]) == 2
        for entry in audit["edgeconv"] + audit["edgeconv_bwd"]:
            assert max(entry["errors"]) == 0.0
        for entry in audit["edgeconv_bwd"]:
            assert 0 <= entry["worst_node"][1] < report["L"]
    assert report["second_step_seconds_per_rank"][0] > 0


def test_layout_spec_takes_the_graph_shape():
    """``--graph-shape B,L`` sets the graph layout's events a data slice
    and nodes an event, and nothing else."""
    spec = dryrun.layout_spec("graph", 4, LONG_L, (2, 64))
    assert (spec["B"], spec["L"], spec["shape"]) == (4, 64, (2, 2))
    assert dryrun.layout_spec("graph_long", 4, LONG_L, (2, 64))["L"] == LONG_L
    assert dryrun.layout_spec("dp", 2, LONG_L, (2, 64)) == dryrun.layout_spec(
        "dp", 2, LONG_L)


# ------------------------------------------- the Trainer's other paths
def _cat(a: EventBatch, b: EventBatch) -> EventBatch:
    return EventBatch(
        x=torch.cat([a.x, b.x]), mask=torch.cat([a.mask, b.mask]),
        n_pulses=torch.cat([a.n_pulses, b.n_pulses]),
        labels={k: torch.cat([a.labels[k], b.labels[k]]) for k in a.labels})


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    local = [dryrun.example_batch(4, 32, seed=10 + i) for i in range(4)]
    materialize(local, os.path.join(root, "store"))
    batches = {
        "train": [dryrun.example_batch(8, 32, seed=20 + i) for i in range(3)],
        "val": [dryrun.example_batch(6, 32, seed=30), dryrun.example_batch(4, 32, seed=31)],
        "ragged": [dryrun.example_batch(5, 32, seed=40), dryrun.example_batch(7, 32, seed=41)],
        "local": local,
    }
    torch.save(batches, os.path.join(root, "batches.pt"))
    return root, batches


@pytest.fixture(scope="module")
def scenarios(data, tmp_path_factory):
    root, _ = data
    out = str(tmp_path_factory.mktemp("scenarios"))
    init = f"file://{os.path.join(tempfile.mkdtemp(), 'store')}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "tools_torch_parallel.py"),
         str(r), "2", init, out, root, *SCENARIOS],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]

    def load(name):
        return [torch.load(os.path.join(out, f"{name}.rank{r}.pt"),
                           weights_only=False)
                for r in range(2)]

    return {name: load(name) for name in SCENARIOS}


def test_fit_over_process_shards_matches_one_process(data, scenarios):
    """``fit`` over ``MaterializedLoader(process_index=, process_count=2)``:
    step t's global batch is rank 0's batch t and rank 1's; the losses
    and the parameters equal one process's fit on those global batches."""
    _, batches = data
    local = batches["local"]
    trainer = Trainer(_model())
    hist = trainer.fit([_cat(local[0], local[2]), _cat(local[1], local[3])],
                       batches["val"], max_epochs=2)
    r0, r1 = scenarios["fit_shards"]
    assert r0["hist"] == r1["hist"]
    np.testing.assert_allclose(r0["hist"]["train_loss"], hist["train_loss"],
                               rtol=LOSS_RTOL)
    _assert_close(r0["params"], trainer.model.state_dict(), "param")


def test_validation_runs_in_lockstep(data, scenarios):
    """Every process reports the same validation loss, the one-process
    event-weighted mean over the global validation batches."""
    _, batches = data
    local = batches["local"]
    trainer = Trainer(_model())
    hist = trainer.fit([_cat(local[0], local[2]), _cat(local[1], local[3])],
                       batches["val"], max_epochs=2)
    r0, r1 = scenarios["fit_shards"]
    assert r0["hist"]["val_loss"] == r1["hist"]["val_loss"]
    np.testing.assert_allclose(r0["hist"]["val_loss"], hist["val_loss"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("scenario,key", [("predict_rows", "ragged"),
                                          ("fit_shards", "val")])
def test_predict_answers_this_process_events(data, scenarios, scenario, key):
    """Each process predicts exactly its events of each global batch
    (mesh padding dropped); rank 0's rows then rank 1's, batch by batch,
    are the one-process predictions."""
    _, batches = data
    r0, r1 = scenarios[scenario]
    model = _model()
    if scenario == "fit_shards":
        model.load_state_dict(r0["params"])
    preds = Trainer(model).predict(batches[key])
    offset0 = offset1 = 0
    rows = []
    for b in batches[key]:
        half = -(-b.batch_size // 2)
        rows.append(("r0", offset0, half))
        rows.append(("r1", offset1, b.batch_size - half))
        offset0, offset1 = offset0 + half, offset1 + b.batch_size - half
    for task, exp in enumerate(preds):
        got = np.concatenate([
            (r0 if who == "r0" else r1)["predict"][task][o:o + n]
            for who, o, n in rows])
        np.testing.assert_allclose(got, exp, rtol=LOSS_RTOL, atol=1e-6)
    assert r0["predict"][0].shape[0] == sum(-(-b.batch_size // 2)
                                            for b in batches[key])


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_resume_matches_an_unbroken_run(scenarios, mode):
    """Two epochs with checkpoints (one file a process), then a new
    Trainer resumes to four: the parameters and the last two epochs'
    losses equal an unbroken four-epoch run's."""
    r0, r1 = scenarios[f"resume_{mode}"]
    assert r0["files"] == ["rank0.pt", "rank1.pt"]
    assert len(r0["hist"]["train_loss"]) == 2
    np.testing.assert_allclose(r0["hist"]["train_loss"],
                               r0["whole_hist"]["train_loss"][2:], rtol=RESUME_RTOL)
    _assert_close(r0["params"], r0["whole_params"], "param", rtol=RESUME_RTOL,
                  atol=0.0)
    _assert_close(r1["params"], r0["params"], "param", rtol=0.0, atol=0.0)


def test_dropout_masks_are_rows_of_the_global_draw(data, scenarios):
    """A TITO with dropout under DP: each process draws its rows of the
    global batch's masks, so the step equals one process's step."""
    _, batches = data
    model = dropout_model()
    loss = float(Trainer(model).train_step(batches["train"][0]))
    r0, r1 = scenarios["dropout_dp"]
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], loss, rtol=LOSS_RTOL)
    _assert_close(r0["grads"], {n: p.grad for n, p in model.named_parameters()},
                  "grad")


def test_clipping_under_fsdp_takes_the_whole_norm(data, scenarios):
    """``clip_grad_norm`` under FSDP clips by the norm of the whole
    gradient (the shards' squares summed over the processes): the step
    equals one process's clipped step."""
    _, batches = data
    model = _model()
    Trainer(model, clip_grad_norm=0.5).train_step(batches["train"][0])
    r0, _ = scenarios["clip_fsdp"]
    _assert_close(r0["params"], model.state_dict(), "param")


# ----------------------------------------------------- row 1 past 32
@pytest.mark.parametrize("k,D", [(33, 3), (48, 3), (64, 4), (40, 4)])
def test_knn_past_k32_matches_jax(k, D):
    """Row 1's plain version (what the rounds kernel is held to on the
    card) at k > 32 against the JAX package's XLA kNN: the same
    neighbours in the same order wherever there is an edge."""
    rng = np.random.default_rng(k + D)
    L = 96
    events = [rng.standard_normal((int(n), D)).astype(np.float32) * 30
              for n in (96, 70, 40, 1)]
    tb = dryrun_make(events, L)
    jb = jax_batch(tb)
    i_x, m_x = map(np.asarray, jax_knn_graph(jb.x, jb.mask, k=k))
    i_t, m_t = (t.numpy() for t in knn_graph(tb.x, tb.mask, k=k))
    np.testing.assert_array_equal(m_t, m_x)
    np.testing.assert_array_equal(np.where(m_t, i_t, -1), np.where(m_x, i_x, -1))
    assert m_t[0].all() and not m_t[-1].any()


def dryrun_make(events, L):
    from graphnet_tpu_torch.batch import make_batch

    n = len(events)
    labels = {"total_energy": np.full(n, 100.0, np.float32),
              "direction": np.tile(np.float32([0, 0, 1]), (n, 1))}
    return make_batch(events, labels=labels, length=L)


@pytest.mark.parametrize("layout", GRAPH_LAYOUTS)
def test_graph_step_counts_its_collectives(graph_runs, layout):
    """Each process of a DP x graph step gathers node rows (all-gather
    bytes counted) and all-reduces the whole model's fp32 gradient
    through DDP."""
    reports, _ = graph_runs
    r = reports[layout]
    for got in r["collective_bytes_per_rank"]:
        assert got["ddp_grad"] == 4 * r["n_params"]
        assert got["all_gather"] > 0
