#!/usr/bin/env python3
"""Row 1 (the kNN) and the DynEdge path around it, for one tree of the
port, on one NVIDIA GPU: run it on two trees in turns (parent, change,
change, parent) in one call to compare them on one card.

    python3 tools/knn_times.py [--tree DIR] [--label NAME]

``--tree`` is the root of a checkout whose ``graphnet_tpu_torch`` is
measured (default: this one), by this tree's ``chip_smoke.py``
functions, so both trees are held to the same yardstick.  Prints the
card's ``nvidia-smi`` name and power limit, then one JSON line:

* ``knn``: ``chip_smoke.knn_times`` at its ``KNN_SHAPES``;
* ``knn_plain_cpu_ms``: the plain version (the CPU route) at those
  shapes on the host's CPU, host ms of one call;
* ``launch_floor``: ``chip_smoke.launch_floor``;
* ``dynedge``: ``chip_smoke.dynedge_switch_times`` of the full-width
  DynEdge energy model (random weights from a seed) on the times
  phase's requests and batch.

Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def dynedge_times(torch, cs, dev):
    from graphnet_tpu_torch.batch import make_batch
    from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
    from graphnet_tpu_torch.models.components import layers
    from graphnet_tpu_torch.models.graphs.graph_definition import Event
    from graphnet_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(cs.SEED)
    tree = cs.jax_layout_tree(rng, **cs.FULL_WIDTH)
    with tempfile.TemporaryDirectory() as tmp:
        pkl = os.path.join(tmp, "state_dict.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(tree, f)
        gpu, gpu16 = (DeploymentModule(cs.dynedge_energy_model("cuda", dtype), pkl)
                      for dtype in (None, "bfloat16"))
    requests = cs.make_requests(rng, Event)
    batch = cs.synthetic_batch(make_batch, np.random.default_rng(cs.SEED)).to(dev)
    trainer, trainer16 = (
        Trainer(cs.dynedge_energy_trainable(cs.trainable_tree(tree), dev, dtype))
        for dtype in (None, "bfloat16"))
    return cs.dynedge_switch_times(torch, layers, gpu, gpu16, requests["b128_L128"],
                                   requests["one_event"], trainer, trainer16, batch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("knn_times: no CUDA device is available", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from graphnet_tpu_torch.kernels import build
    from graphnet_tpu_torch.ops.knn import knn_graph_plain
    from graphnet_tpu_torch.ops.knn_cuda import knn_graph_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = cs.PEAKS["PCIe" if "PCIe" in name else "SXM"]
    build.build(["knn", "edgeconv", "edgeconv_knn", "edgeconv_bwd"])
    dev = torch.device("cuda")
    cpu_ms = {}
    for label, B, L, D, lo, *k in cs.KNN_SHAPES:  # a tree before k = 32: no k
        k = k[0] if k else cs.K
        x, m = cs.ragged_coords(torch, np.random.default_rng(cs.SEED + 5), B, L, lo,
                                "cpu", D=D)
        cpu_ms[label] = 1e3 * cs.host_s(lambda: knn_graph_plain(x, m, k), runs=5)
    result = {
        "label": args.label, "tree": args.tree, "card": smi,
        "knn": cs.knn_times(torch, knn_graph_cuda, knn_graph_plain, dev, peaks),
        "knn_plain_cpu_ms": cpu_ms,
        "launch_floor": cs.launch_floor(torch, build),
        "dynedge": dynedge_times(torch, cs, dev),
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
