"""A copy of the benchmark with tiny cells added as files only, for the
CPU tests: the harness must find a configuration, a traffic mix, a metric
reader and limits that a later change adds without editing a file."""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import yaml

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_DYNEDGE = dict(
    nb_inputs=14, nb_neighbours=8, features_subset=[0, 1, 2],
    dynedge_layer_sizes=[[16, 32], [24, 32]], post_processing_layer_sizes=[24, 16],
    readout_layer_sizes=[8], global_pooling_schemes=["min", "max", "mean"],
    add_global_variables_after_pooling=False, activation_layer="relu",
    add_norm_layer=False, skip_readout=False, compute_dtype=None)
TINY_DEEPICE = dict(
    hidden_dim=32, mlp_ratio=2, seq_length=16, depth=1, head_size=16,
    depth_rel=2, n_rel=1, scaled_emb=False, include_dynedge=False,
    dynedge_args=None, n_features=6)
TINY_CELLS = {
    "tiny_dynedge.train": ("tiny_dynedge", "tiny_train"),
    "tiny_dynedge.serve": ("tiny_dynedge", "tiny_reprocess"),
    "tiny_deepice.train": ("tiny_deepice", "tiny_train"),
    "tiny_deepice.serve": ("tiny_deepice", "tiny_reprocess"),
}
# limits of the tiny cells on the CPU, where program and reference run
# the same plain arithmetic in different orders (read: at most 7e-7)
# and the control rounds the products' inputs to TF32 (read: 1e-4 or more)
TINY_LIMITS = {
    "tiny_dynedge.train": {"loss_gap": 1e-5, "grad_gap": 1e-5, "update_gap": 1e-5,
                           "adam_gap": 1e-5, "knn_mismatch": 0},
    "tiny_dynedge.serve": {"row_gap": 1e-5, "row_gap_median": 1e-5,
                           "knn_mismatch": 0, "rerun_gap": 0},
    "tiny_deepice.train": {"loss_gap": 1e-5, "grad_gap": 1e-5, "update_gap": 1e-5,
                           "adam_gap": 1e-5},
    "tiny_deepice.serve": {"row_gap": 1e-5, "row_gap_median": 1e-5},
}


def tiny_config(base: str, widths: dict, max_pulses: int) -> dict:
    cfg = yaml.safe_load(open(BENCH / "configs" / f"{base}.yml"))
    cfg["model"]["arguments"]["backbone"]["__model__"]["arguments"] = widths
    cfg["max_pulses"] = max_pulses
    cfg["reduced"] = sorted(widths)
    return cfg


def make_root(tmp: Path, extra_metric: bool = True) -> Path:
    """A checkout in ``tmp``: the benchmark's files, the port linked in, and
    the tiny cells' files and entries added."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    (root / "graphnet_tpu_torch").symlink_to(REPO / "graphnet_tpu_torch")
    bench = json.load(open(REPO / "BENCHMARK.json"))
    b = root / "benchmark"
    for name, (base, widths, n) in {
            "tiny_dynedge": ("queso_energy", TINY_DYNEDGE, 24),
            "tiny_deepice": ("icemix_b_d32", TINY_DEEPICE, 20)}.items():
        (b / "configs" / f"{name}.yml").write_text(
            yaml.safe_dump(tiny_config(base, widths, n), sort_keys=False))
        bench["configs"].append({"name": name, "source": "test", "reduced": [],
                                 "file": f"benchmark/configs/{name}.yml",
                                 "why": "test"})
    for name, base, extra in (("tiny_train", "train_b128",
                               dict(events=48, batch_size=8)),
                              ("tiny_reprocess", "reprocess_r32",
                               dict(events=40, request_events=8,
                                    check_requests=2))):
        mix = yaml.safe_load(open(b / "traffic" / f"{base}.yml"))
        mix.update(extra)
        mix["lengths"] = dict(mix["lengths"], median=8)
        mix["pulses"] = dict(mix["pulses"], anchors=16, neighbourhood=32)
        (b / "traffic" / f"{name}.yml").write_text(yaml.safe_dump(mix))
    for cell, (cfg, mix) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": mix,
                                   "chips": 1, "why": "test"})
        kind = cell.rsplit(".", 1)[1]
        (b / "limits" / f"{cell}.yml").write_text(
            yaml.safe_dump({"limits": TINY_LIMITS[cell]}))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(w.endswith("." + kind)
                                        for w in m["workloads"]):
                m["workloads"].append(cell)
    if extra_metric:
        (b / "metrics" / "steps_done.py").write_text(
            '"""Steps or requests the window ran (a test\'s metric)."""\n\n\n'
            "def read(rec):\n    return float(rec.calls)\n")
        bench["end_to_end"].append({"name": "steps_done", "unit": "steps",
                                    "better": "higher", "bound": 0.1,
                                    "source": "host_clock",
                                    "workloads": list(TINY_CELLS)})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run_main(root: Path, argv, **kwargs):
    """``benchmark/run.py``'s ``main`` of the checkout at ``root``."""
    spec = importlib.util.spec_from_file_location(
        "portbench_run_" + str(abs(hash(str(root)))), root / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv, **kwargs)


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])
