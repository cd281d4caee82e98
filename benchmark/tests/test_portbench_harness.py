"""The harness's counters, its isolation check and its refusals: the
training padding share equals the DataLoader's over one epoch; the
serving share is read from the batches ``DeploymentModule`` hands its
model, so a change to the module's padding moves it; nothing of
the benchmark imports JAX or the JAX package; ``run.py`` prints no result
without a card or without the program; the trace reader."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import portbench_tiny as pt
from harness import spec, traffic
from harness.cells import Cell, Record, RecordingDataset, batch_slots
from harness.isolation import FORBIDDEN, forbidden_modules
from harness.trace import parse


def test_padding_efficiency_equals_the_loaders_over_an_epoch():
    from graphnet_tpu_torch.data.dataloader import DataLoader
    from graphnet_tpu_torch.models.graphs.graph_definition import Event

    cfg, mix = spec.config("queso_energy"), dict(spec.traffic("train_b128"), events=700)
    ev = traffic.make_events(cfg, mix, 3)
    ds = RecordingDataset([Event(x=ev.event(i), features=ev.features,
                                 labels=ev.label_row(i)) for i in range(len(ev))],
                          ev.n)
    loader = DataLoader(ds, batch_size=64, shuffle=True, seed=3)
    rec = Record(kind="train", model_cfg={}, counts=None, peaks={}, dtype="float32")
    for batch in loader:
        rec.slots.append(batch_slots(batch))
    share = spec.reader("padding_efficiency.train").read(rec)
    assert share == pytest.approx(100.0 * loader.padding_efficiency, rel=1e-12)


class _Off:
    on = False

    def span(self, name):
        import contextlib

        return contextlib.nullcontext()


def serve_slots(root, requests=3):
    """A traced tiny reprocessing cell's slots over ``requests`` requests,
    with what the port's own collate and batch padding make of each."""
    from graphnet_tpu_torch.data.dataloader import collate_events
    from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule

    cell = Cell("tiny_dynedge.serve", 2 ** 31 + 3, 1.0, True, device="cpu",
                root=root)
    cell.setup()
    cell._span_batches, cell._answers = {}, {}
    for i in range(requests):
        cell._one(i, _Off())
    cell._tally(cell.rec, 0)
    want = [batch_slots(DeploymentModule._pad_batch_size(
        collate_events(cell.request_objs[j], min_pulses=1)))
        for j in range(requests)]
    return cell.rec, want


def test_serving_padding_is_read_from_the_batches_the_model_receives(tiny_root):
    rec, want = serve_slots(tiny_root)
    assert rec.slots == want
    assert all(t > v > 0 for v, t in rec.slots)
    share = spec.reader("padding_efficiency.serve", tiny_root).read(rec)
    assert share == pytest.approx(100.0 * sum(v for v, _ in want)
                                  / sum(t for _, t in want))


def test_serving_padding_moves_with_the_modules_padding(tiny_root, monkeypatch):
    """A padding fix in the Request layer (each request padded to its
    longest event, not to that event's bucket) moves the share."""
    from graphnet_tpu_torch.deployment import deployment_module as dm

    padded, _ = serve_slots(tiny_root)
    collate = dm.collate_events
    monkeypatch.setattr(dm, "collate_events", lambda events, min_pulses: collate(
        events, length=max(e.n_pulses for e in events), min_pulses=min_pulses))
    unpadded, _ = serve_slots(tiny_root)
    assert [v for v, _ in unpadded.slots] == [v for v, _ in padded.slots]
    assert sum(t for _, t in unpadded.slots) < sum(t for _, t in padded.slots)


def test_isolation_by_whole_top_level_names():
    assert FORBIDDEN == {"jax", "jaxlib", "flax", "optax", "graphnet_tpu"}
    assert forbidden_modules(["graphnet_tpu_torch", "graphnet_tpu_torch.ops",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["graphnet_tpu.ops", "jax", "optax.tree",
                              "graphnet_tpu_torch"]) == ["graphnet_tpu.ops", "jax",
                                                         "optax.tree"]


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_benchmark_source_imports_jax_and_references_import_no_program():
    for path in pt.BENCH.rglob("*.py"):
        found = forbidden_modules(imports(path))
        assert not found, (path, found)
    for path in (pt.BENCH / "reference").glob("*.py"):
        tops = {m.split(".", 1)[0] for m in imports(path)}
        assert "graphnet_tpu_torch" not in tops, path


def run_py(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=300)


def test_run_fails_without_a_card():
    p = run_py(pt.REPO, "--workload", "queso_energy.serve", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    shutil.copytree(pt.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(pt.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = run_py(tmp_path, "--workload", "queso_energy.serve", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and "{" not in p.stdout


def test_trace_reader_attributes_device_time(tmp_path):
    def X(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "pid": 1, "args": args}

    events = [
        X("user_annotation", "bench.window", 0, 100),
        X("user_annotation", "bench.step#0", 0, 50),
        X("user_annotation", "bench.loader#1", 50, 40),
        X("cpu_op", "graphnet_tpu_torch::knn_graph", 10, 5,
          **{"Input Dims": [[2, 8, 3], [2, 8], [], []], "Input type": ["float", "bool"],
             "Concrete Inputs": ["", "", "8", "True"], "External id": 7}),
        X("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=42),
        X("kernel", "knn_kernel", 20, 10, tid=7, correlation=42, **{"External id": 7}),
        X("kernel", "gemm", 40, 10, tid=7, correlation=43),
        X("gpu_memcpy", "Memcpy HtoD", 45, 10, tid=8, correlation=44),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = parse(str(path))
    assert tr.window_s == pytest.approx(1e-4)
    assert tr.busy_s == pytest.approx(25e-6)
    (op,) = tr.ops
    assert op.name == "knn_graph" and op.device_us == 10 and op.span == "bench.step#0"
    assert op.scalar(2, 1.0) == 8.0 and op.shapes[0] == [2, 8, 3]
    gaps = tr.idle_gaps()
    assert gaps[0] == ["bench.loader", pytest.approx(45e-6)]
    assert tr.device_ops()[0][0] in ("knn_kernel", "gemm", "Memcpy HtoD")
