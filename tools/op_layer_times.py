#!/usr/bin/env python3
"""Host cost of the kernel operators (``torch.library``) on the DynEdge
serving and training path, for one tree of the port, on one NVIDIA GPU:
run it on two trees in turns (parent, change, change, parent) in one
call to compare them on one card.

    python3 tools/op_layer_times.py [--tree DIR] [--label NAME]

``--tree`` is the root of a checkout whose ``graphnet_tpu_torch`` is
measured (default: this one), by this tree's ``chip_smoke.py``
functions, so both trees are held to the same yardstick.  Prints the
card's ``nvidia-smi`` name and power limit, then one JSON line:

* ``dynedge``: the full-width DynEdge energy model (random weights from
  a seed) through ``DeploymentModule``: the single-event request's host
  p50 ms (``one_event``, 57 pulses), the 128-event request's host ms
  (``b128_L128``) and its events/s, and a fp32 training step's ms (CUDA
  events, the synthetic B=128, L=128 batch), each median of
  ``--repeats`` medians;
* ``dispatch`` (trees whose kernels are operators): host microseconds a
  call of row 1 takes to return at the single event's shape (B=1,
  L=128), mean over ``--calls`` calls: its CUDA implementation called
  directly, the operator (``torch.library.Library``, as the port
  registers it) through ``knn_graph_cuda``, and a
  ``torch.library.custom_op`` of the same implementation defined here.

Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def dynedge_times(torch, cs, dev, repeats):
    from graphnet_tpu_torch.batch import make_batch
    from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
    from graphnet_tpu_torch.models.graphs.graph_definition import Event
    from graphnet_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(cs.SEED)
    tree = cs.jax_layout_tree(rng, **cs.FULL_WIDTH)
    with tempfile.TemporaryDirectory() as tmp:
        pkl = os.path.join(tmp, "state_dict.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(tree, f)
        gpu = DeploymentModule(cs.dynedge_energy_model("cuda"), pkl)
    requests = cs.make_requests(rng, Event)
    single, serving = requests["one_event"], requests["b128_L128"]
    batch = cs.synthetic_batch(make_batch, np.random.default_rng(cs.SEED)).to(dev)
    trainer = Trainer(cs.dynedge_energy_trainable(cs.trainable_tree(tree), dev))
    runs = {"single_event_p50_ms": [], "serving_ms_B128_L128": [],
            "train_step_ms_fp32_B128_L128": []}
    for _ in range(repeats):
        runs["single_event_p50_ms"].append(
            1e3 * cs.host_s(lambda: gpu(single), runs=41))
        runs["serving_ms_B128_L128"].append(
            1e3 * cs.host_s(lambda: gpu(serving)))
        runs["train_step_ms_fp32_B128_L128"].append(
            cs.cuda_ms(torch, lambda: trainer.train_step(batch), runs=20))
    out = {key: {"median": statistics.median(v), "runs": v}
           for key, v in runs.items()}
    out["serving_events_per_s_B128_L128"] = (
        128e3 / out["serving_ms_B128_L128"]["median"])
    return out


def dispatch_times(torch, cs, dev, calls):
    """Host microseconds a row-1 call takes to return, three ways."""
    try:
        from graphnet_tpu_torch.ops import knn_cuda
        from graphnet_tpu_torch.ops.library import NAMESPACE  # noqa: F401
    except ImportError:  # a tree before the kernels became operators
        return None
    x, m = cs.ragged_coords(torch, np.random.default_rng(cs.SEED + 5), 1, 128,
                            128, dev)
    impl = knn_cuda._knn_cuda
    custom = torch.library.custom_op(
        "op_layer_times::knn_graph", impl, mutates_args=(),
        device_types="cuda",
        schema="(Tensor coords, Tensor mask, int k, bool exclude_self)"
        " -> (Tensor, Tensor)")
    custom.register_fake(knn_cuda._knn_fake)
    ways = {
        "cuda_implementation": lambda: impl(x, m, cs.K, True),
        "library_operator": lambda: knn_cuda.knn_graph_cuda(x, m, cs.K),
        "custom_op": lambda: custom(x, m, cs.K, True),
    }
    out = {}
    for _ in range(3):  # the ways in turns, three times
        for key, fn in ways.items():
            out.setdefault(key, []).append(
                1e3 * cs.host_enqueue_ms(torch, fn, calls=calls))
    return {key: {"median_us": statistics.median(v), "runs_us": v}
            for key, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("op_layer_times: no CUDA device is available", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from graphnet_tpu_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build(["knn", "edgeconv", "edgeconv_bwd"])
    dev = torch.device("cuda")
    result = {
        "label": args.label, "tree": args.tree, "card": smi,
        "torch": torch.__version__,
        "dispatch": dispatch_times(torch, cs, dev, args.calls),
        "dynedge": dynedge_times(torch, cs, dev, args.repeats),
        "seconds": time.perf_counter() - t0,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
