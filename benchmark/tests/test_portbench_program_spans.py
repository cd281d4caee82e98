"""The program's own spans (``graphnet.*`` ranges, which the port records
while a profiler session is on): they leave everything the trace reader
gives as it is (the window, the busy time, the bench spans, the idle gaps
and their names, the device time and bench span of each operator call,
and the metrics read from them); and ``harness/spans.py`` splits the
idle time by them as counted by hand."""

import json
import types

import numpy as np
import pytest

from harness import spec
from harness.peaks import peaks_for
from harness.roofline import share
from harness.spans import OUTSIDE, idle_by_span
from harness.trace import parse


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


BENCH = [
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
PROGRAM = [
    X("user_annotation", "graphnet.trainer.step", 1, 48),
    X("user_annotation", "graphnet.trainer.h2d", 1, 3),
    X("user_annotation", "graphnet.trainer.forward", 4, 16),
    X("user_annotation", "graphnet.trainer.backward", 20, 25),
    X("user_annotation", "graphnet.trainer.optimizer", 45, 4),
    X("user_annotation", "graphnet.loader.batch", 52, 36),
    X("user_annotation", "graphnet.loader.fetch", 52, 10),
    X("user_annotation", "graphnet.loader.collate", 62, 26),
    X("gpu_user_annotation", "graphnet.trainer.forward", 20, 10, tid=7),
]


def _read(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = parse(str(path))
    for call in tr.ops:
        call.n, call.batch_length = np.array([6, 8]), 8
    return tr


def test_program_spans_change_no_reading(tmp_path):
    plain = _read(tmp_path, BENCH)
    spanned = _read(tmp_path, BENCH + PROGRAM)
    assert spanned.window == plain.window
    assert spanned.busy_s == plain.busy_s
    assert spanned.spans == plain.spans
    assert spanned.device_ops() == plain.device_ops()
    assert spanned.idle_gaps() == plain.idle_gaps()
    assert [(c.name, c.span, c.device_us) for c in spanned.ops] == \
        [(c.name, c.span, c.device_us) for c in plain.ops] == \
        [("knn_graph", "bench.step#0", 10.0)]
    formulas = lambda op: spec.module("rooflines", op)  # noqa: E731
    peaks = peaks_for("NVIDIA H100 80GB HBM3")
    assert share(spanned.ops, formulas, peaks) == share(plain.ops, formulas, peaks)
    for name in ("idle_share.train", "kernel_roofline.train"):
        reader = spec.reader(name)
        got = [reader.read(types.SimpleNamespace(
            trace=tr, formulas=formulas, peaks=peaks)) for tr in (plain, spanned)]
        assert got[0] == got[1] and got[0] is not None
    assert spanned.idle_gaps()[0] == ["bench.loader", pytest.approx(45e-6)]


def test_idle_by_span_on_a_hand_built_trace(tmp_path):
    """Window [0, 100) µs.  The device is busy over [10, 30), [40, 47),
    [60, 70) and [80, 90) (kernels, a copy and a set; a kernel before the
    window left out), so idle over [0, 10), [30, 40), [47, 60), [70, 80)
    and [90, 100): 53 µs, each instant given to the innermost program
    span of the window's thread."""
    trace = {"traceEvents": [
        X("user_annotation", "bench.window", 0, 100),
        X("user_annotation", "bench.step#0", 0, 47),
        X("user_annotation", "graphnet.trainer.step", 2, 45),
        X("user_annotation", "graphnet.trainer.h2d", 2, 6),
        X("user_annotation", "graphnet.trainer.optimizer", 35, 10),
        X("user_annotation", "Optimizer.step#Adam.step", 36, 8),
        X("user_annotation", "bench.request#1", 50, 47),
        X("user_annotation", "graphnet.deploy.request", 52, 36),
        X("user_annotation", "graphnet.deploy.collate", 52, 15),
        X("user_annotation", "graphnet.deploy.d2h", 75, 13),
        # another thread
        X("user_annotation", "graphnet.loader.batch", 30, 40, tid=2),
        X("kernel", "k", -5, 4),
        X("kernel", "k", 10, 10),
        X("gpu_memcpy", "m", 15, 15),
        X("kernel", "k", 40, 7),
        X("gpu_memset", "s", 60, 10),
        X("kernel", "k", 80, 10),
        X("gpu_user_annotation", "bench.step#0", 10, 37),
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    got = idle_by_span(str(path))
    assert got["window_us"] == [0.0, 100.0]
    assert got["idle_us"] == 53.0
    assert got["idle_by_span"] == {
        OUTSIDE: 2 + 5 + 10,                    # [0,2) [47,52) [90,100)
        "graphnet.trainer.h2d": 6,              # [2,8)
        "graphnet.trainer.step": 2 + 5,         # [8,10) [30,35)
        "graphnet.trainer.optimizer": 5,        # [35,40)
        "graphnet.deploy.collate": 8,           # [52,60)
        "graphnet.deploy.request": 5,           # [70,75)
        "graphnet.deploy.d2h": 5,               # [75,80)
    }
    assert got["idle_by_layer"] == {OUTSIDE: 17,
                                    "graphnet.trainer": 18,
                                    "graphnet.deploy": 18}
    # the layers and the idle in no span make up the window's idle
    busy = 20 + 7 + 10 + 10
    assert sum(got["idle_by_layer"].values()) == got["idle_us"] == 100 - busy
    assert got["host_us"] == {
        "graphnet.trainer.step": [45, 1], "graphnet.trainer.h2d": [6, 1],
        "graphnet.trainer.optimizer": [10, 1],
        "graphnet.deploy.request": [36, 1], "graphnet.deploy.collate": [15, 1],
        "graphnet.deploy.d2h": [13, 1]}
    # named at the midpoint: [47, 60) starts outside every span
    assert got["gaps"] == [
        ["graphnet.deploy.collate", 13], ["graphnet.trainer.h2d", 10],
        ["graphnet.trainer.optimizer", 10], ["graphnet.deploy.d2h", 10],
        ["bench.request", 10]]
    with pytest.raises(ValueError):
        idle_by_span(trace, window="no.such.span")
