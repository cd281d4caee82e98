#!/usr/bin/env python3
"""Where the rel dK/dV kernel's time goes, on one NVIDIA GPU.

    python3 tools/rel_dkv_parts.py

Builds ``graphnet_tpu_torch/csrc/rel_flash_attention_bwd.cu`` as it is
and with parts of the dkv kernel cut out at compile time, then times
each build's ``rel_bwd_dkv_launch`` (CUDA events around one call, the
median of 20) at DeepIce's shape, B=16, H=12, L=768, hd=32, full events,
in bf16 and fp32.  The cuts:

* ``no_phase_a``: no embedding dots (phase A);
* ``no_phase_b``: no products (phase B);
* ``loads_only``: neither, leaving the streamed tiles and the syncs;
* ``no_sincos``: phase A with its ``sincosf`` replaced by a multiply.

A cut build computes other numbers: this is a measurement, not a check.
The difference between the whole kernel and a cut is that part's cost.
Prints the card's ``nvidia-smi`` name and power limit, then one JSON
line of ms per build and dtype.  Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from graphnet_tpu_torch.kernels import build  # noqa: E402
from graphnet_tpu_torch.ops import rel_flash_attention as rp  # noqa: E402
from graphnet_tpu_torch.ops import rel_flash_attention_cuda as rc  # noqa: E402

SOURCE = build.CSRC / "rel_flash_attention_bwd.cu"
HEADER = build.CSRC / "rel_flash_attention.cuh"  # emb_frags, shared code
B, H, L, HD = 16, 12, 768, 32

# (text of the source, its replacement, occurrences)
PHASE_A = ("    dkv_phase_a<HD>(", "    if (t < 0) dkv_phase_a<HD>(", 2)
PHASE_B = [
    ("      if (unit >= units) continue;", "      if (unit >= 0) continue;", 1),
    ("    if (owner) {\n      const float* ks =",
     "    if (owner && w < 0) {\n      const float* ks =", 1),
]
SINCOS = ("        float sn, cs;\n        sincosf(x, &sn, &cs);",
          "        float sn = x, cs = x * 0.5f;", 1)
CUTS = {
    "whole": [],
    "no_phase_a": [PHASE_A],
    "no_phase_b": PHASE_B,
    "loads_only": [PHASE_A] + PHASE_B,
    "no_sincos": [SINCOS],
}


def cut_sources(cuts, source=SOURCE):
    """The texts of ``source`` and of the rel header with the cuts made:
    each cut's text must occur ``count`` times in the two together."""
    texts = {p.name: p.read_text() for p in (source, HEADER)}
    for old, new, count in cuts:
        if sum(t.count(old) for t in texts.values()) != count:
            raise RuntimeError(f"the cut {old!r} no longer matches the source")
        texts = {n: t.replace(old, new) for n, t in texts.items()}
    return texts


def build_all(tmp: str, cuts_by_name=None, entry: str = "rel_bwd_dkv_launch",
              n_out: int = 2, source=SOURCE, n_in: int = 12):
    """One library a cut (``CUTS`` by default) of ``source``, all nvcc
    processes at once, each in its own directory beside its cut copy of
    the rel header: each library's C entry ``entry`` (``n_in`` input and
    ``n_out`` output pointers), and the whole build's compiler log."""
    procs = {}
    for name, cuts in (cuts_by_name or CUTS).items():
        os.makedirs(os.path.join(tmp, name))
        for fname, text in cut_sources(cuts, source).items():
            with open(os.path.join(tmp, name, fname), "w") as f:
                f.write(text)
        src = os.path.join(tmp, name, source.name)
        so = os.path.join(tmp, f"{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", so, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    fns, log = {}, ""
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        fn = getattr(ctypes.CDLL(so), entry)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * n_in + [I] * 6 + [P] * n_out + [P]
        fn.restype = I
        fns[name] = fn
        log = out if name == "whole" else log
    return fns, log


def inputs(dtype, dev):
    """The dkv kernel's arguments at (B, H, L, HD) from a seed, from the
    forward kernel's o, oe and lse; x0 by the JAX bench's DeepIce recipe."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    x0 = np.concatenate([rng.standard_normal((B, L, 3)), rng.random((B, L, 2)),
                         rng.random((B, L, 1)) > 0.5], axis=-1)
    x0 = torch.from_numpy(x0.astype(np.float32)).to(dev)
    mask = torch.ones(B, L, dtype=torch.bool, device=dev)
    w = torch.randn(HD, HD, device=dev, generator=gen) / HD ** 0.5
    b = torch.randn(HD, device=dev, generator=gen) * 0.1
    q, k, v = (torch.randn(B, H, L, HD, device=dev, generator=gen).to(dtype)
               for _ in range(3))
    q = q * HD ** -0.5
    args = (q, q.float() @ w, q.float() @ b, k, v, x0, mask)
    o, oe, lse = rc.rel_attention_fwd(*args)
    do = torch.randn(o.shape, device=dev, generator=gen).to(dtype)
    doe = torch.randn(oe.shape, device=dev, generator=gen)
    full = list(args + (lse, do, doe, rp.rel_attention_delta(do, o, doe, oe)))
    full.insert(7, torch.from_numpy(rp._freqs(HD)).to(dev))
    return [t.contiguous() for t in full]


def time_ms(fn, ins, dtype, dev, runs=20, outs=None):
    """The median of ``runs`` calls of ``fn`` by CUDA events; ``outs``
    the output tensors (by default the dkv kernel's dk and dv)."""
    if outs is None:
        dk = torch.empty(ins[3].shape, dtype=dtype, device=dev)
        outs = (dk, torch.empty_like(dk))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        err = fn(*(t.data_ptr() for t in ins), B, H, L, HD, ins[5].shape[-1],
                 int(dtype == torch.bfloat16), *(t.data_ptr() for t in outs),
                 stream)
        if err:
            raise RuntimeError(f"rel kernel launch: CUDA error {err}")

    for _ in range(3):
        call()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("rel_dkv_parts: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
        flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns, _ = build_all(tmp)
        result = {}
        for dtype in (torch.bfloat16, torch.float32):
            ins = inputs(dtype, dev)
            key = str(dtype).replace("torch.", "")
            result[key] = {name: time_ms(fn, ins, dtype, dev)
                           for name, fn in fns.items()}
    print(json.dumps({"B": B, "H": H, "L": L, "hd": HD, "ms": result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
