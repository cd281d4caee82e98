#!/usr/bin/env python3
"""DeepIce's chunked bias routes on one NVIDIA GPU: ms and peak memory
of the zoo's B_d32 (hidden 768, 24 heads of 32, rel kernels off, 4
query tiles) serving and training in fp32, on the dense route
(``rel_bias_chunks`` 1), the cached route (``rel_bias_cache="always"``)
and the rebuilt one (``"never"``).

    python3 tools/deepice_chunked_times.py [--shapes 16x256 16x768 4x3072] [--runs N]

``chip_smoke.py``'s ``chunked_costs`` at each ``BxL`` (full-length
random events, CUDA events around each call, the median of ``--runs``;
the peak is ``torch.cuda.max_memory_allocated`` over one call).  Prints
the card's ``nvidia-smi`` name and power limit, then one JSON line.
These are the measurements behind ``REL_CACHE_AUTO_BYTES``
(``graphnet_tpu_torch/models/gnn/icemix.py``).  Needs ``nvcc`` and a
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", nargs="+",
                        default=["16x256", "16x384", "16x512", "16x640",
                                 "16x768", "4x3072"])
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from graphnet_tpu_torch.batch import make_batch
    from graphnet_tpu_torch.kernels import build
    from graphnet_tpu_torch.training.trainer import Trainer
    from graphnet_tpu_torch.utils.jax_params import params_to_jax

    if not torch.cuda.is_available():
        print("deepice_chunked_times: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    build.build(["flash_attention", "flash_attention_bwd"])
    tree = cs.ice_jax_layout_tree(np.random.default_rng(cs.SEED + 31),
                                  cs.chunked_model("cpu"), params_to_jax)
    shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes]
    costs = cs.chunked_costs(torch, make_batch, Trainer, tree,
                             torch.device("cuda"), shapes=shapes,
                             runs=args.runs)
    cs.emit({"card": smi, "chunks": cs.CHUNKED_CHUNKS, "runs": args.runs,
             "costs_fp32": costs})
    return 0


if __name__ == "__main__":
    sys.exit(main())
