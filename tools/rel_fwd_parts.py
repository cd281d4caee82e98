#!/usr/bin/env python3
"""Where the rel forward kernel's time goes, on one NVIDIA GPU.

    python3 tools/rel_fwd_parts.py

Builds ``graphnet_tpu_torch/csrc/rel_flash_attention.cu`` as it is and
with parts of the forward kernel cut out at compile time, then times
each build's ``rel_fwd_launch`` (CUDA events around one call, the median
of 20) at DeepIce's shape, B=16, H=12, L=768, hd=32, full events, in
bf16 and fp32 (the build, inputs and timing of
``tools/rel_dkv_parts.py``).  The cuts:

* ``no_phase_a``: no qt.emb (phase A), so no embedding built;
* ``no_phase_b``: no q.k, softmax or p.v (phase B);
* ``no_qk``, ``no_pv``: phase B without q.k (S from the dots alone), or
  without p.v;
* ``no_phase_c``: no p.emb (phase C);
* ``loads_only``: none of the three, leaving the streamed tiles and the
  barriers;
* ``no_sincos``: the embedding's ``sincosf`` replaced by a multiply.

A cut build computes other numbers: this is a measurement, not a check.
The difference between the whole kernel and a cut is that part's cost.
Prints the card's ``nvidia-smi`` name and power limit, the forward
kernel's registers, spills and stack from the whole build's ``ptxas``
report, then one JSON line of ms per build and dtype.  Needs ``nvcc``
and a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import rel_dkv_parts as parts  # noqa: E402

SOURCE = parts.build.CSRC / "rel_flash_attention.cu"
# (text of the source, its replacement, occurrences)
PHASE_A = ("fwd_phase_a<HD>(qts,", "if (w < 0) fwd_phase_a<HD>(qts,", 2)
PHASE_B = ("    fwd_phase_b<T, HD>(kvs,", "    if (w < 0) fwd_phase_b<T, HD>(kvs,", 1)
PHASE_C = ("    fwd_phase_c<HD>(dots,", "    if (w < 0) fwd_phase_c<HD>(dots,", 1)
QK = ("  fwd_qk<HD>(st,", "  if (h < 0) fwd_qk<HD>(st,", 1)
PV = ("  fwd_pv<HD>(O, st,", "  if (h < 0) fwd_pv<HD>(O, st,", 1)
CUTS = {
    "whole": [],
    "no_phase_a": [PHASE_A],
    "no_phase_b": [PHASE_B],
    "no_qk": [QK],
    "no_pv": [PV],
    "no_phase_c": [PHASE_C],
    "loads_only": [PHASE_A, PHASE_B, PHASE_C],
    "no_sincos": [parts.SINCOS],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("rel_fwd_parts: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
        flush=True)
    B, H, L, HD = parts.B, parts.H, parts.L, parts.HD
    with tempfile.TemporaryDirectory() as tmp:
        fns, log = parts.build_all(tmp, CUTS, "rel_fwd_launch", 3, SOURCE, 8)
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line if "rel_fwd_kernel" in line else None
            elif kernel and ("registers" in line or "stack frame" in line):
                print(kernel.split("'")[1], line.strip(), flush=True)
        result = {}
        for dtype in (torch.bfloat16, torch.float32):
            ins = parts.inputs(dtype, dev)[:8]  # q, qt, qb, k, v, x0, mask, freqs
            outs = (torch.empty(B, H, L, HD, dtype=dtype, device=dev),
                    torch.empty(B, H, L, HD, device=dev),
                    torch.empty(B, H, L, device=dev))
            key = str(dtype).replace("torch.", "")
            result[key] = {name: parts.time_ms(fn, ins, dtype, dev, outs=outs)
                           for name, fn in fns.items()}
    print(json.dumps({"B": B, "H": H, "L": L, "hd": HD, "ms": result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
