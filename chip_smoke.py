#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``graphnet_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (also printed as the raw
   ``nvidia-smi --query-gpu=name,power.limit`` line);
2. build: compiles every CUDA kernel of the serving path from
   ``graphnet_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
3. knn: the kNN kernel against its plain PyTorch version on the card;
4. edgeconv: the fused EdgeConv kernel against its plain version;
5. serve: the main path.  A full-width DynEdge energy model is loaded
   from a JAX-layout ``state_dict.pkl`` (random weights from a seed)
   through ``DeploymentModule`` on the card and answers requests; the
   kernels' launch counts are checked (5 kNN and 4 EdgeConv per
   forward) and the answers are held against the same module on the
   CPU, which runs the plain versions.  Then the bfloat16 mode;
6. times: each kernel, its plain version and its bound; serving
   events/s and single-event latency; device time by kernel;
7. a ``kernels`` line with every ported kernel.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no such line; it also
exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
K = 8
NB_INPUTS = 4
FEATURES = ["sensor_pos_x", "sensor_pos_y", "sensor_pos_z", "t"]
FULL_WIDTH = dict(
    layer_sizes=((128, 256), (336, 256), (336, 256), (336, 256)),
    post=(336, 256),
    readout=(128,),
)
# H100 data sheet, dense rates: bytes/s of HBM, flop/s of the CUDA cores
# in fp32 and of the tensor cores in bf16 (for the bound column)
PEAKS = {
    "SXM": dict(bytes=3.35e12, fp32=67e12, bf16=989e12),
    "PCIe": dict(bytes=2.0e12, fp32=51e12, bf16=756e12),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events, one call each)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_s(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median wall time of ``fn`` in s; ``fn`` ends with its results on
    the host, so the device work lies inside the window."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def jax_layout_tree(rng, layer_sizes, post, readout):
    """A DynEdge + energy-head parameter tree in the JAX package's layout
    (``{"params": {"backbone": ..., "tasks_0": ...}}``, numpy arrays,
    dense kernels ``[in, out]``), with random weights."""

    def dense(din, dout, bias=True):
        d = {"kernel": rng.standard_normal((din, dout)) / np.sqrt(din)}
        if bias:
            d["bias"] = rng.standard_normal(dout) * 0.1
        return d

    n_global = NB_INPUTS + min(4, NB_INPUTS) + 1
    d = d_skip = NB_INPUTS + n_global
    backbone = {}
    for i, (h1, h2) in enumerate(layer_sizes):
        backbone[f"conv_{i}"] = {
            "conv": {
                "self_dense": dense(d, h1),
                "nbr_dense": dense(d, h1, bias=False),
                "out_kernel": rng.standard_normal((h1, h2)) / np.sqrt(h1),
                "out_bias": rng.standard_normal(h2) * 0.1,
            }
        }
        d = h2
        d_skip += h2
    d = d_skip
    backbone["post_processing"] = {}
    for j, h in enumerate(post):
        backbone["post_processing"][f"dense_{j}"] = dense(d, h)
        d = h
    d *= 4  # min, max, mean, sum pooling
    backbone["readout"] = {}
    for j, h in enumerate(readout):
        backbone["readout"][f"dense_{j}"] = dense(d, h)
        d = h
    tree = {"params": {"backbone": backbone, "tasks_0": {"affine": dense(d, 1)}}}

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return np.asarray(t, dtype=np.float32)

    return f32(tree)


def ragged_coords(torch, rng, B, L, lo, dev):
    """``[B, L, 3]`` float32 coordinates and a mask with lengths drawn
    from ``[lo, L]``."""
    x = torch.from_numpy(rng.standard_normal((B, L, 3)).astype(np.float32))
    n = torch.from_numpy(rng.integers(lo, L + 1, B))
    mask = torch.arange(L)[None, :] < n[:, None]
    return x.to(dev), mask.to(dev)


def knn_flips(torch, x, mask, ia, ma, ib, mb):
    """Compare two kNN graphs of the same points.  ``edge_mask`` must be
    identical; where indices differ, the chosen squared distances
    (recomputed in fp64) must agree within 1e-5 relative: a near-tie.
    Returns (flips, max |d2a - d2b| over the valid edges)."""
    assert torch.equal(ma, mb), "edge_mask differs"
    xd = x.double()

    def d2(i):
        flat = i.long().reshape(i.shape[0], -1, 1).expand(-1, -1, 3)
        nb = torch.gather(xd, 1, flat).reshape(*i.shape, 3)
        return ((nb - xd[:, :, None, :]) ** 2).sum(-1)

    da, db = d2(ia), d2(ib)
    diff = torch.where(ma, (da - db).abs(), 0.0)
    scale = torch.maximum(da.abs(), db.abs()).clamp_min(1e-30)
    assert bool((diff <= 1e-5 * scale).all()), "kNN picks differ beyond a tie"
    return int(((ia != ib) & ma).sum()), float(diff.max())


def check_knn(torch, ops, rng, dev):
    """Phase 3: the kNN kernel against its plain version."""
    cases = [("B128_L128_ragged",) + ragged_coords(torch, rng, 128, 128, 64, dev)]
    x, m = ragged_coords(torch, rng, 3, 16, 16, dev)
    m[0, 1:] = False  # 1 node
    m[1, 5:] = False  # 5 nodes
    m[2] = False  # all masked, as a padded request row
    cases.append(("tiny_events_L16", x, m))
    cases.append(("one_event_L1024",) + ragged_coords(torch, rng, 1, 1024, 900, dev))
    cases.append(("B2_L4096",) + ragged_coords(torch, rng, 2, 4096, 3000, dev))
    worst, report = 0.0, []
    for label, x, m in cases:
        ik, mk = ops["knn"](x, m, K)
        ip, mp = ops["knn_plain"](x, m, K)
        assert not bool(mk[~m].any()), "an edge on an invalid query"
        flips, err = knn_flips(torch, x, m, ik, mk, ip, mp)
        worst = max(worst, err)
        report.append({"case": label, "edges": int(mk.sum()),
                       "tie_flips": flips, "max_abs_d2_err": err})
    return worst, report


def check_edgeconv(torch, ops, rng, dev, B=128, L=128,
                   shapes=((128, 256), (336, 256))):
    """Phase 4: the EdgeConv kernel against its plain version."""
    x, m = ragged_coords(torch, rng, B, L, L // 2, dev)
    idx, em = ops["knn_plain"](x, m, K)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    report = []
    for h1, h2 in shapes:
        g = torch.Generator(device=dev).manual_seed(h1)
        a = torch.randn(B, L, h1, device=dev, generator=g)
        b = torch.randn(B, L, h1, device=dev, generator=g)
        w2 = torch.randn(h1, h2, device=dev, generator=g) / h1 ** 0.5
        b2 = torch.randn(h2, device=dev, generator=g) * 0.1
        for dtype, aggr, slope, mean in (
            (torch.float32, "add", 0.0, False),
            (torch.float32, "max", 0.01, False),
            (torch.float32, "add", 0.0, True),
            (torch.bfloat16, "add", 0.0, False),
        ):
            args = [a.to(dtype), b.to(dtype), idx, em, w2.to(dtype), b2.to(dtype)]
            ok = ops["edgeconv"](*args, aggr=aggr, slope=slope)
            op = ops["edgeconv_plain"](*args, aggr=aggr, slope=slope)
            if mean:
                n = em.sum(dim=2, keepdim=True).clamp_min(1)
                ok, op = ok / n, op / n
            err = float((ok - op).abs().max())
            key = str(dtype).replace("torch.", "")
            if dtype == torch.float32:
                # fp32 throughout: only the summation order differs
                torch.testing.assert_close(ok, op, rtol=1e-4, atol=1e-4)
                rel = None
            else:
                # the same bf16 operands, fp32 sums in another order
                rel = err / float(op.abs().max())
                assert rel <= 2e-2, f"bf16 EdgeConv off by {rel} of max"
            worst[key] = max(worst[key], err)
            report.append({"H1": h1, "H2": h2, "dtype": key,
                           "aggr": "mean" if mean else aggr, "slope": slope,
                           "max_abs_err": err, "rel_to_max": rel})
    return worst, report


def make_requests(rng, Event):
    def events(lengths):
        return [
            Event(x=rng.standard_normal((int(n), NB_INPUTS)).astype(np.float32),
                  features=FEATURES)
            for n in lengths
        ]

    return {
        "one_event": events([57]),
        "seven_with_empty": events([30, 0, 5, 1, 64, 17, 100]),
        "b128_buckets_16_512": events(
            np.concatenate([[16, 512], rng.integers(2, 513, 126)])),
        "b128_L128": events(rng.integers(65, 129, 128)),
    }


def _convs(module):
    bb = module.model.backbone
    return [getattr(bb, f"conv_{i}") for i in range(bb.n_convs)]


def _record(module, store):
    """Hooks keeping each DynEdgeConv's input adjacency, output latents
    and rebuilt adjacency."""

    def hook(mod, args, out):
        store.append((args[2], args[3], out[0], out[1], out[2]))

    return [c.register_forward_hook(hook) for c in _convs(module)]


def _adjacencies(store):
    """The 5 graphs of a forward: the initial one, then one per conv."""
    return [store[0][:2]] + [s[3:5] for s in store]


def serve(torch, gpu, cpu, requests, counters, dev, collate_events):
    """Phase 5: the main path.  Every request goes through ``gpu`` with
    the launch counts checked per forward, then through ``cpu``; events
    that differ beyond rtol 1e-3 must be explained by kNN near-tie
    flips, and with the CPU run's adjacency fed to the card every layer
    and every event must agree within 1e-3."""
    for c in counters:
        c.launches = 0
    answers, rec = {}, {}
    for label, evs in requests.items():
        store = []
        handles = _record(gpu, store)
        before = [c.launches for c in counters]
        answers[label] = gpu(evs)
        for h in handles:
            h.remove()
        rec[label] = store
        rose = [c.launches - b for c, b in zip(counters, before)]
        assert rose == [5, 4], f"{label}: launches rose by {rose}, not [5, 4]"
    launches = [c.launches for c in counters]

    report = []
    for label, evs in requests.items():
        store = []
        handles = _record(cpu, store)
        ref = cpu(evs)
        for h in handles:
            h.remove()
        got = answers[label]
        empty = np.array([e.n_pulses == 0 for e in evs])
        kept = np.flatnonzero(~empty)
        assert got.shape == (len(evs), 1)
        assert np.isnan(got[empty]).all() and np.isfinite(got[kept]).all()
        close = np.isclose(got, ref, rtol=1e-3, atol=0.0)[:, 0] | empty
        flip_events = np.zeros(len(evs), bool)
        flips = []
        for (gi, gm), (ci, cm) in zip(_adjacencies(rec[label]),
                                      _adjacencies(store)):
            diff = ((gi.cpu() != ci) & cm) | (gm.cpu() != cm)
            flips.append(int(diff.sum()))
            flip_events[kept[diff.flatten(1).any(1).numpy()[: len(kept)]]] = True
        unexplained = np.flatnonzero(~close & ~flip_events)
        assert unexplained.size == 0, (
            f"{label}: events {unexplained.tolist()} differ from the CPU "
            "with no kNN flip")

        # layer by layer, with the CPU run's adjacency fed to the card
        batch = gpu._pad_batch_size(collate_events(evs, min_pulses=1))
        batch.edges, batch.edge_mask = store[0][0], store[0][1]

        def pre(i):
            def hook(mod, args):
                return (args[0], args[1], store[i][0].to(dev),
                        store[i][1].to(dev))
            return hook

        injected = []
        handles = [c.register_forward_pre_hook(pre(i))
                   for i, c in enumerate(_convs(gpu))]
        handles += _record(gpu, injected)
        with torch.inference_mode():
            pred = gpu.model(batch.to(dev), inference=True)[0][0]
        for h in handles:
            h.remove()
        pred = pred[: len(kept)].float().cpu().numpy()
        np.testing.assert_allclose(
            pred, ref[kept], rtol=1e-3, atol=0.0,
            err_msg=f"{label}: prediction with the CPU adjacency")
        layer_err = []
        for g, c in zip(injected, store):
            e = float((g[2].cpu() - c[2]).abs().max()) / max(
                float(c[2].abs().max()), 1e-30)
            assert e <= 1e-3, f"{label}: a layer is off by {e} of its max"
            layer_err.append(e)
        report.append({
            "request": label, "events": len(evs),
            "padded_B": batch.batch_size, "L": batch.max_length,
            "events_beyond_rtol_1e-3": int((~close).sum()),
            "events_with_knn_flips": int(flip_events.sum()),
            "knn_flips_per_graph": flips,
            "layer_rel_err_with_cpu_adjacency": layer_err,
            "max_rel_err": float(np.max(
                np.abs(got[kept] - ref[kept]) / np.abs(ref[kept]))),
        })
    return answers, launches, report


def serve_bf16(gpu16, requests, answers, counters):
    """The bfloat16 serving mode: finite answers, its own launch counts."""
    for c in counters:
        c.launches = 0
    report = []
    for label, evs in requests.items():
        out = gpu16(evs)
        empty = np.array([e.n_pulses == 0 for e in evs])
        assert np.isfinite(out[~empty]).all() and np.isnan(out[empty]).all()
        ref = answers[label][~empty]
        report.append({"request": label, "max_rel_diff_to_fp32": float(
            np.max(np.abs(out[~empty] - ref) / np.abs(ref)))})
    launches = [c.launches for c in counters]
    assert launches == [5 * len(requests), 4 * len(requests)], launches
    return launches, report


def kernel_times(torch, ops, rng, dev, peaks):
    """Phase 6a: each kernel and its plain version at the serving shape
    (B=128, L=128, k=8; EdgeConv at H1=336, H2=256), with its bound."""
    B, L, H1, H2 = 128, 128, 336, 256
    x, m = ragged_coords(torch, rng, B, L, 65, dev)
    idx, em = ops["knn"](x, m, K)
    n = m.sum(1).double()
    ops_knn = 10.0 * float((n * n).sum())  # ~10 flops per valid pair
    bytes_knn = B * L * (3 * 4 + 1) + B * L * K * (4 + 1)
    t_b, t_o = bytes_knn / peaks["bytes"], ops_knn / peaks["fp32"]
    times = {"knn": dict(
        ms=cuda_ms(torch, lambda: ops["knn"](x, m, K)),
        plain_ms=cuda_ms(torch, lambda: ops["knn_plain"](x, m, K)),
        bound_ms=max(t_b, t_o) * 1e3,
        bound_by="bytes" if t_b >= t_o else "operations",
    )}
    n_edges = float(em.sum())
    flops = n_edges * (2.0 * H1 * H2 + 2 * H1 + 3 * H2)
    g = torch.Generator(device=dev).manual_seed(1)
    for key, dtype, rate in (
        ("edgeconv_fwd", torch.float32, peaks["fp32"]),
        ("edgeconv_fwd_bf16", torch.bfloat16, peaks["bf16"]),
    ):
        a = torch.randn(B, L, H1, device=dev, generator=g).to(dtype)
        b = torch.randn(B, L, H1, device=dev, generator=g).to(dtype)
        w2 = (torch.randn(H1, H2, device=dev, generator=g) / H1 ** 0.5).to(dtype)
        b2 = torch.zeros(H2, device=dev, dtype=dtype)
        el = a.element_size()
        nbytes = (2 * B * L * H1 * el + B * L * K * 5 + (H1 + 1) * H2 * el
                  + B * L * H2 * 4)
        t_b, t_o = nbytes / peaks["bytes"], flops / rate
        times[key] = dict(
            ms=cuda_ms(torch, lambda: ops["edgeconv"](a, b, idx, em, w2, b2)),
            plain_ms=cuda_ms(
                torch, lambda: ops["edgeconv_plain"](a, b, idx, em, w2, b2)),
            bound_ms=max(t_b, t_o) * 1e3,
            bound_by="bytes" if t_b >= t_o else "operations",
        )
    return times


def device_profile(torch, fn, calls=5):
    """Phase 6c: device time by kernel over ``calls`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        rows.append((us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    return {
        "calls": calls, "wall_ms": wall_ms, "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "top": [{"kernel": k[:100], "ms": t, "count": c}
                for t, k, c in rows[:12]],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from graphnet_tpu_torch.data.dataloader import collate_events
    from graphnet_tpu_torch.deployment.deployment_module import (
        DeploymentModule,
    )
    from graphnet_tpu_torch.kernels import build
    from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
    from graphnet_tpu_torch.models.graphs.graph_definition import Event
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import (
        EnergyReconstruction,
    )
    from graphnet_tpu_torch.ops.edgeconv_cuda import (
        fused_edgeconv,
        fused_edgeconv_plain,
    )
    from graphnet_tpu_torch.ops.knn import knn_graph_plain
    from graphnet_tpu_torch.ops.knn_cuda import knn_graph_cuda

    ops = dict(knn=knn_graph_cuda, knn_plain=knn_graph_plain,
               edgeconv=fused_edgeconv, edgeconv_plain=fused_edgeconv_plain)
    counters = (knn_graph_cuda, fused_edgeconv)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    peaks = PEAKS["PCIe" if "PCIe" in name else "SXM"]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_assumed": peaks})

    # 2. build
    t0 = time.perf_counter()
    logs = build.build(["knn", "edgeconv"])
    ptxas = {n: [l.strip() for l in log.splitlines()
                 if "registers" in l or "spill" in l]
             for n, log in logs.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "ptxas": ptxas})

    # 3. kNN kernel vs plain
    t0 = time.perf_counter()
    knn_err, report = check_knn(torch, ops, rng, dev)
    emit({"phase": "knn", "k": K, "cases": report,
          "seconds": round(time.perf_counter() - t0, 2)})

    # 4. EdgeConv kernel vs plain
    t0 = time.perf_counter()
    ec_err, report = check_edgeconv(torch, ops, rng, dev)
    emit({"phase": "edgeconv", "B": 128, "L": 128, "k": K, "cases": report,
          "seconds": round(time.perf_counter() - t0, 2)})

    # 5. the main path: serving through DeploymentModule
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    pkl = os.path.join(tmp, "state_dict.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(jax_layout_tree(rng, **FULL_WIDTH), f)

    def make_model(device, compute_dtype=None):
        return StandardModel(
            DynEdge(nb_inputs=NB_INPUTS, compute_dtype=compute_dtype),
            [EnergyReconstruction(hidden_size=128)],
            device=device,
        )

    requests = make_requests(rng, Event)
    gpu = DeploymentModule(make_model("cuda"), pkl)
    cpu = DeploymentModule(make_model("cpu"), pkl, device="cpu")
    answers, launches, report = serve(
        torch, gpu, cpu, requests, counters, dev, collate_events)
    emit({"phase": "serve", "dtype": "float32", "requests": report,
          "launches": {"knn": launches[0], "edgeconv": launches[1],
                       "forwards": len(requests)},
          "seconds": round(time.perf_counter() - t0, 2)})

    t0 = time.perf_counter()
    gpu16 = DeploymentModule(make_model("cuda", "bfloat16"), pkl)
    launches16, report = serve_bf16(gpu16, requests, answers, counters)
    emit({"phase": "serve_bf16", "requests": report,
          "launches": {"knn": launches16[0], "edgeconv": launches16[1],
                       "forwards": len(requests)},
          "seconds": round(time.perf_counter() - t0, 2)})
    os.remove(pkl)
    os.rmdir(tmp)

    # 6. times
    t0 = time.perf_counter()
    times = kernel_times(torch, ops, rng, dev, peaks)
    serving = requests["b128_L128"]
    single = requests["one_event"]
    emit({
        "phase": "times", "card": smi, "kernels": times,
        "serving_B128_L128": {
            "fp32_events_per_s": 128 / host_s(lambda: gpu(serving)),
            "bf16_events_per_s": 128 / host_s(lambda: gpu16(serving)),
            "single_event_p50_ms": 1e3 * host_s(lambda: gpu(single), runs=41),
        },
        "profile_fp32_B128_L128": device_profile(torch, lambda: gpu(serving)),
        "seconds": round(time.perf_counter() - t0, 2),
    })

    # 7. the kernels line
    kernels = [
        dict(name="knn", route="cuda",
             source="graphnet_tpu_torch/csrc/knn.cu",
             replaces="graphnet_tpu/ops/knn_pallas.py:35",
             launches=launches[0], max_abs_err=knn_err,
             **times["knn"], library_ms=None),
        dict(name="edgeconv_fwd", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:66",
             launches=launches[1], max_abs_err=ec_err["float32"],
             **times["edgeconv_fwd"], library_ms=None),
        dict(name="edgeconv_fwd_bf16", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:66",
             launches=launches16[1], max_abs_err=ec_err["bfloat16"],
             **times["edgeconv_fwd_bf16"], library_ms=None),
    ]
    for kern in kernels:
        assert kern["launches"] > 0, f"{kern['name']} was never launched"
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 2)})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
