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
4. edgeconv: the fused EdgeConv forward kernel against its plain version;
5. edgeconv_bwd: the EdgeConv backward kernel against its plain version
   (both layer shapes, add/max/mean, fp32 and bf16, a 1-node and an
   all-masked event, L=512 and L=4096), and whether two runs give the
   same bits;
6. serve: the serving path.  A full-width DynEdge energy model is loaded
   from a JAX-layout ``state_dict.pkl`` (random weights from a seed)
   through ``DeploymentModule`` on the card and answers requests; the
   kernels' launch counts are checked (5 kNN and 4 EdgeConv per
   forward, no backward) and the answers are held against the same
   module on the CPU, which runs the plain versions.  Then the bfloat16
   mode;
7. train: the training path.  ``Trainer`` steps of the same model with
   ``LogCoshLoss`` on ``log10(total_energy)`` on the JAX bench's batch
   (B=128, L=128); 5 kNN, 4 EdgeConv-forward and 4 EdgeConv-backward
   launches per step, a finite, non-zero gradient for every parameter,
   and losses and gradients held against the port on the CPU with the
   CPU's adjacency fed to the card; then ``fit`` with validation,
   ``predict`` and the ``state_dict.pkl`` round trip.  Then the
   bfloat16 mode;
8. times: each kernel, its plain version and its bound; serving
   events/s and single-event latency; training step ms and events/s;
   device time by kernel for serving and for training; peak memory of
   a training step;
9. a ``kernels`` line with every ported kernel.

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
from dataclasses import replace

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
    """Phase 4: the EdgeConv forward kernel against its plain version."""
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
    """Phase 6: the serving path.  Every request goes through ``gpu`` with
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
        assert rose == [5, 4, 0], f"{label}: launches rose by {rose}, not [5, 4, 0]"
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
    assert launches == [5 * len(requests), 4 * len(requests), 0], launches
    return launches, report


def kernel_times(torch, ops, rng, dev, peaks):
    """Phase 8a: each kernel and its plain version at the serving shape
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


def trainable_tree(tree):
    """``tree`` with the energy head's affine kernel made positive and
    scaled by 1e-2.  The random tree's latents reach ~1e4 (sum pooling
    over the nodes), so its head starts deep in the softplus's flat
    side, where every gradient vanishes; the readout's output is
    non-negative (relu), so a small positive kernel starts the head in
    the targets' range instead."""
    head = tree["params"]["tasks_0"]["affine"]
    return {"params": {
        **tree["params"],
        "tasks_0": {"affine": {**head, "kernel": np.abs(head["kernel"]) * 1e-2}},
    }}


def act(torch, x, slope):
    return torch.where(x > 0, x, slope * x)


def zero_ambiguous(torch, a, b, idx, em, w2, b2, g, aggr, slope, rel=1e-5):
    """``g`` with 0 at each (node, channel) where the backward is
    discontinuous within rounding: an edge's second-layer pre-activation
    within ``rel`` of its max from 0 (the gate), or, under max, the top
    two valid edges within that of each other (the argmax).  Two correct
    implementations that sum in another order may decide these either
    way; everywhere else their gradients are continuous.  Returns the
    new ``g`` and the count of entries set to 0."""
    from graphnet_tpu_torch.ops.gather_reduce import gather_neighbors

    z = a.float()[:, :, None, :] + gather_neighbors(b, idx).float()
    msgs = act(torch, z, slope).to(w2.dtype).double()
    pre2 = torch.matmul(msgs, w2.double()) + b2.double()
    thr = rel * float(pre2.abs().max())
    m = em[..., None]
    amb = ((pre2.abs() <= thr) & m).any(dim=2)
    if aggr == "max" and idx.shape[2] > 1:
        top = torch.where(m, act(torch, pre2, slope), -1e30).topk(2, dim=2).values
        amb |= (top[:, :, 0] - top[:, :, 1] <= thr) & (top[:, :, 1] > -1e29)
    return torch.where(amb, 0.0, g), int(amb.sum())


def check_edgeconv_bwd(torch, ops, rng, dev, B=128, L=128,
                       shapes=((128, 256), (336, 256))):
    """Phase 5: the EdgeConv backward kernel against its plain version,
    each of da, db, dW2, db2 within 1e-4 (fp32) or 2e-2 (bf16) of the
    plain output's max |value|; the kernel runs twice and the bits of
    the two runs are compared."""
    x, m = ragged_coords(torch, rng, B, L, L // 2, dev)
    main = ops["knn_plain"](x, m, K)
    xt, mt = ragged_coords(torch, rng, 3, 16, 16, dev)
    mt[0, 1:] = False  # 1 node: no edge
    mt[1] = False  # all masked, as a padding row
    mt[2, 5:] = False  # 5 nodes: fewer than k neighbours
    tiny = ops["knn_plain"](xt, mt, K)
    g512 = ops["knn_plain"](*ragged_coords(torch, rng, 1, 512, 400, dev), K)
    g4096 = ops["knn_plain"](*ragged_coords(torch, rng, 1, 4096, 3000, dev), K)
    f32, b16 = torch.float32, torch.bfloat16
    cases = []
    for h1, h2 in shapes:
        cases += [(f"B{B}_L{L}", main, h1, h2, f32, "add", 0.0, False),
                  (f"B{B}_L{L}", main, h1, h2, f32, "max", 0.01, False),
                  (f"B{B}_L{L}", main, h1, h2, f32, "add", 0.0, True),
                  (f"B{B}_L{L}", main, h1, h2, b16, "add", 0.0, False)]
    cases += [("tiny_events_L16", tiny, 128, 256, f32, "add", 0.0, False),
              ("tiny_events_L16", tiny, 128, 256, f32, "max", 0.01, False),
              ("one_event_L512", g512, 336, 256, f32, "add", 0.0, False),
              ("one_event_L512", g512, 336, 256, b16, "add", 0.0, False),
              ("one_event_L4096", g4096, 336, 256, f32, "add", 0.0, False)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    report = []
    for label, (idx, em), h1, h2, dtype, aggr, slope, mean in cases:
        Bc, Lc = idx.shape[:2]
        gen = torch.Generator(device=dev).manual_seed(h1 + Lc)
        a = torch.randn(Bc, Lc, h1, device=dev, generator=gen).to(dtype)
        b = torch.randn(Bc, Lc, h1, device=dev, generator=gen).to(dtype)
        w2 = (torch.randn(h1, h2, device=dev, generator=gen) / h1 ** 0.5).to(dtype)
        b2 = (torch.randn(h2, device=dev, generator=gen) * 0.1).to(dtype)
        g = torch.randn(Bc, Lc, h2, device=dev, generator=gen)
        if mean:  # the gradient of add divided by the valid-edge count
            g = g / em.sum(dim=2, keepdim=True).clamp_min(1)
        g, zeroed = zero_ambiguous(torch, a, b, idx, em, w2, b2, g, aggr, slope)
        args = (a, b, idx, em, w2, b2, g)
        got = ops["edgeconv_bwd"](*args, aggr=aggr, slope=slope)
        again = ops["edgeconv_bwd"](*args, aggr=aggr, slope=slope)
        exp = ops["edgeconv_bwd_plain"](*args, aggr=aggr, slope=slope)
        key = str(dtype).replace("torch.", "")
        tol = 1e-4 if dtype == f32 else 2e-2
        rel = {}
        for name, o, e in zip(("da", "db", "dw2", "db2"), got, exp):
            err, scale = float((o - e).abs().max()), float(e.abs().max())
            assert err <= tol * scale, (
                f"{label} H1={h1} {key} {aggr}: {name} off by {err}, more "
                f"than {tol} of its max {scale}")
            rel[name] = err / scale
            worst[key] = max(worst[key], err)
        if label.startswith("tiny"):  # no edge, no gradient
            for t in got[:2]:
                assert not bool(t[0].any()) and not bool(t[1].any())
        report.append({
            "case": label, "H1": h1, "H2": h2, "dtype": key,
            "aggr": "mean" if mean else aggr, "slope": slope,
            "edges": int(em.sum()), "g_zeroed_ambiguous": zeroed,
            "rel_err_to_max": rel,
            "same_bits_twice": all(torch.equal(p, q) for p, q in zip(got, again)),
        })
    return worst, report


def synthetic_batch(make_batch, rng, B=128, L=128):
    """The JAX bench's training batch, made here by a copy of the recipe
    of ``bench.py``'s ``_synthetic_batch``: lengths L/2..L, xyz from
    N(0, 2^2), a uniform fourth feature, ``total_energy`` =
    |N(200, 100^2)|."""
    events = []
    for _ in range(B):
        n = int(rng.integers(L // 2, L + 1))
        events.append(np.concatenate(
            [rng.standard_normal((n, 3)).astype(np.float32) * 2.0,
             rng.random((n, 1)).astype(np.float32)], axis=1))
    labels = {"total_energy": np.abs(
        rng.standard_normal(B).astype(np.float32) * 100 + 200)}
    return make_batch(events, labels=labels, length=L)


def model_convs(model):
    bb = model.backbone
    return [getattr(bb, f"conv_{i}") for i in range(bb.n_convs)]


def record_adjacency(model, store):
    """Pre-hooks keeping each DynEdgeConv's input adjacency."""

    def hook(mod, args):
        store.append((args[2], args[3]))

    return [c.register_forward_pre_hook(hook) for c in model_convs(model)]


def feed_adjacency(model, graphs, dev):
    """Pre-hooks replacing each DynEdgeConv's input adjacency with
    ``graphs[i]`` (a list the caller refills before each step)."""

    def pre(i):
        def hook(mod, args):
            return (args[0], args[1], graphs[i][0].to(dev),
                    graphs[i][1].to(dev))
        return hook

    return [c.register_forward_pre_hook(pre(i))
            for i, c in enumerate(model_convs(model))]


def run_steps(torch, trainer, batches, counters=(), before_step=None):
    """One ``Trainer.train_step`` per batch.  Per step: the loss, the
    launch counts risen, the parameters whose gradient is not finite or
    is all zero; for step 1 also every gradient and update, on the
    host."""
    model = trainer.model
    out = {"loss": [], "rose": [], "nonfinite": [], "zero": []}
    for s, batch in enumerate(batches):
        if before_step is not None:
            before_step(s)
        counts = [c.launches for c in counters]
        p0 = [p.detach().clone() for p in model.parameters()]
        out["loss"].append(float(trainer.train_step(batch)))
        out["rose"].append([c.launches - n for c, n in zip(counters, counts)])
        named = list(model.named_parameters())
        out["nonfinite"].append([n for n, p in named if p.grad is None
                                 or not bool(torch.isfinite(p.grad).all())])
        out["zero"].append([n for n, p in named
                            if p.grad is not None and not bool(p.grad.any())])
        if s == 0:
            out["grads1"] = {n: p.grad.float().cpu() for n, p in named}
            out["update1"] = {n: (p.detach() - q).float().cpu()
                              for (n, p), q in zip(named, p0)}
    return out


def train(torch, make, Trainer, batch, counters, dev, steps=3):
    """Phase 7: the main training path on the card, held against the
    CPU.  ``make(device, compute_dtype)`` builds the model with the
    JAX-layout weights loaded; ``batch`` is on the CPU."""
    cpu_store = []
    cpu_model = make("cpu")
    n_conv = len(model_convs(cpu_model))
    handles = record_adjacency(cpu_model, cpu_store)
    cpu = run_steps(torch, Trainer(cpu_model), [batch] * steps)
    for h in handles:
        h.remove()
    cpu_graphs = [cpu_store[s * n_conv:(s + 1) * n_conv] for s in range(steps)]

    # the main path: no help from the CPU
    gpu_model = make(dev)
    gpu_store = []
    handles = record_adjacency(gpu_model, gpu_store)
    on_card = batch.to(dev)
    for c in counters:
        c.launches = 0
    gpu = run_steps(torch, Trainer(gpu_model), [on_card] * steps, counters)
    launches = [c.launches for c in counters]
    for h in handles:
        h.remove()
    assert all(r == [5, 4, 4] for r in gpu["rose"]), gpu["rose"]
    assert not any(gpu["nonfinite"]) and not any(gpu["zero"]), (
        gpu["nonfinite"], gpu["zero"])
    flips = []
    for s in range(steps):
        n = 0
        for (gi, gm), (ci, cm) in zip(gpu_store[s * n_conv:(s + 1) * n_conv],
                                      cpu_graphs[s]):
            n += int((((gi.cpu() != ci) & cm) | (gm.cpu() != cm)).sum())
        flips.append(n)

    # the CPU run's adjacency fed to the card
    fed_model = make(dev)
    graphs = list(cpu_graphs[0])

    def refill(s):
        graphs[:] = cpu_graphs[s]

    handles = feed_adjacency(fed_model, graphs, dev)
    fed_batches = [replace(on_card, edges=cpu_graphs[s][0][0].to(dev),
                           edge_mask=cpu_graphs[s][0][1].to(dev))
                   for s in range(steps)]
    fed = run_steps(torch, Trainer(fed_model), fed_batches, before_step=refill)
    for h in handles:
        h.remove()
    np.testing.assert_allclose(fed["loss"], cpu["loss"], rtol=1e-3,
                               err_msg="losses with the CPU adjacency")
    grad_err, update_err = {}, {}
    for name, gc in cpu["grads1"].items():
        e = float((fed["grads1"][name] - gc).abs().max())
        scale = float(gc.abs().max())
        assert e <= 1e-3 * scale, f"step-1 gradient of {name}: {e} vs max {scale}"
        grad_err[name] = e / scale
        uc = cpu["update1"][name]
        update_err[name] = float((fed["update1"][name] - uc).abs().max())
    worst_u = max(update_err, key=update_err.get)

    # the rest of the user's path: fit with validation, predict, and the
    # state_dict.pkl round trip
    trainer = Trainer(make(dev))
    history = trainer.fit([on_card] * 2, [on_card], max_epochs=2)
    assert np.isfinite(history["train_loss"] + history["val_loss"]).all()
    pred = trainer.predict([on_card])[0]
    assert pred.shape == (batch.batch_size, 1) and np.isfinite(pred).all()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    pkl = os.path.join(tmp, "state_dict.pkl")
    trainer.save_state_dict(pkl)
    again = Trainer(make(dev))
    again.load_state_dict(pkl)
    os.remove(pkl)
    os.rmdir(tmp)
    assert np.array_equal(again.predict([on_card])[0], pred), (
        "predictions moved through save_state_dict / load_state_dict")
    return gpu, {
        "steps": steps, "B": batch.batch_size, "L": batch.max_length,
        "losses_card": gpu["loss"], "losses_cpu": cpu["loss"],
        "losses_card_cpu_adjacency": fed["loss"],
        "launches_per_step": gpu["rose"],
        "every_grad_finite_nonzero": True,
        "knn_flips_vs_cpu_per_step": flips,
        "max_grad_rel_err_step1_cpu_adjacency": max(grad_err.values()),
        "worst_grad_param": max(grad_err, key=grad_err.get),
        "max_abs_adam_update_diff_step1": update_err[worst_u],
        "max_abs_adam_update_step1": float(cpu["update1"][worst_u].abs().max()),
        "worst_update_param": worst_u,
        "fit_history": history,
    }, launches


def train_bf16(torch, make, Trainer, batch, counters, dev, loss_fp32, steps=3):
    """Phase 7b: bf16 training on the card from the same weights."""
    model = make(dev, "bfloat16")
    on_card = batch.to(dev)
    for c in counters:
        c.launches = 0
    out = run_steps(torch, Trainer(model), [on_card] * steps, counters)
    launches = [c.launches for c in counters]
    assert all(r == [5, 4, 4] for r in out["rose"]), out["rose"]
    assert np.isfinite(out["loss"]).all() and not any(out["nonfinite"]), out
    rel = abs(out["loss"][0] - loss_fp32) / abs(loss_fp32)
    assert rel <= 2e-2, f"bf16 step-1 loss off the fp32 one by {rel}"
    return {"losses": out["loss"], "launches_per_step": out["rose"],
            "step1_rel_diff_to_fp32": rel,
            "params_with_all_zero_grad": sorted(set(sum(out["zero"], [])))}, launches


def bwd_times(torch, ops, rng, dev, peaks, B=128, L=128,
              shapes=((128, 256), (336, 256))):
    """Phase 8b: the backward kernel and its plain version at the
    training shape, with its bound: 3 products of 2*E*H1*H2 flops over
    the E valid edges, against every input read and output written once."""
    x, m = ragged_coords(torch, rng, B, L, 65, dev)
    idx, em = ops["knn"](x, m, K)
    n_edges = float(em.sum())
    gen = torch.Generator(device=dev).manual_seed(2)
    times = {}
    for h1, h2 in shapes:
        for dtype, rate in ((torch.float32, peaks["fp32"]),
                            (torch.bfloat16, peaks["bf16"])):
            a = torch.randn(B, L, h1, device=dev, generator=gen).to(dtype)
            b = torch.randn(B, L, h1, device=dev, generator=gen).to(dtype)
            w2 = (torch.randn(h1, h2, device=dev, generator=gen) / h1 ** 0.5).to(dtype)
            b2 = torch.zeros(h2, device=dev, dtype=dtype)
            g = torch.randn(B, L, h2, device=dev, generator=gen)
            el = a.element_size()
            nbytes = (2 * B * L * h1 * el + B * L * K * 5 + (h1 + 1) * h2 * el
                      + B * L * h2 * 4 + 2 * B * L * h1 * 4 + (h1 + 1) * h2 * 4)
            flops = n_edges * 3 * 2.0 * h1 * h2
            t_b, t_o = nbytes / peaks["bytes"], flops / rate
            args = (a, b, idx, em, w2, b2, g)
            key = f"H1_{h1}_{str(dtype).replace('torch.', '')}"
            times[key] = dict(
                ms=cuda_ms(torch, lambda: ops["edgeconv_bwd"](*args)),
                plain_ms=cuda_ms(torch, lambda: ops["edgeconv_bwd_plain"](*args)),
                bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
            )
    return times


def train_times(torch, trainer, batch, runs=20):
    """Phase 8c: one training step on a batch already on the card: ms
    (CUDA events around the step, median of ``runs`` after warm-up),
    events/s, and the peak device memory of a step."""
    ms = cuda_ms(torch, lambda: trainer.train_step(batch), runs=runs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    return {"step_ms": ms, "events_per_s": batch.batch_size / ms * 1e3,
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20}


def device_profile(torch, fn, calls=5):
    """Phase 8d: device time by kernel over ``calls`` calls of ``fn``,
    and the share of the wall time the device was idle."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
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

    from graphnet_tpu_torch.batch import make_batch
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
        fused_edgeconv_bwd,
        fused_edgeconv_bwd_plain,
        fused_edgeconv_plain,
    )
    from graphnet_tpu_torch.ops.knn import knn_graph_plain
    from graphnet_tpu_torch.ops.knn_cuda import knn_graph_cuda
    from graphnet_tpu_torch.training.loss_functions import LogCoshLoss
    from graphnet_tpu_torch.training.trainer import Trainer
    from graphnet_tpu_torch.utils.jax_params import params_from_jax

    ops = dict(knn=knn_graph_cuda, knn_plain=knn_graph_plain,
               edgeconv=fused_edgeconv, edgeconv_plain=fused_edgeconv_plain,
               edgeconv_bwd=fused_edgeconv_bwd,
               edgeconv_bwd_plain=fused_edgeconv_bwd_plain)
    counters = (knn_graph_cuda, fused_edgeconv, fused_edgeconv_bwd)
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
    logs = build.build(["knn", "edgeconv", "edgeconv_bwd"])
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

    # 4. EdgeConv forward kernel vs plain
    t0 = time.perf_counter()
    ec_err, report = check_edgeconv(torch, ops, rng, dev)
    emit({"phase": "edgeconv", "B": 128, "L": 128, "k": K, "cases": report,
          "seconds": round(time.perf_counter() - t0, 2)})

    # 5. EdgeConv backward kernel vs plain
    t0 = time.perf_counter()
    bwd_err, report = check_edgeconv_bwd(torch, ops, rng, dev)
    emit({"phase": "edgeconv_bwd", "k": K, "cases": report,
          "seconds": round(time.perf_counter() - t0, 2)})

    # 6. the serving path through DeploymentModule
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    pkl = os.path.join(tmp, "state_dict.pkl")
    tree = jax_layout_tree(rng, **FULL_WIDTH)
    with open(pkl, "wb") as f:
        pickle.dump(tree, f)

    def make_model(device, compute_dtype=None, **task):
        return StandardModel(
            DynEdge(nb_inputs=NB_INPUTS, compute_dtype=compute_dtype),
            [EnergyReconstruction(hidden_size=128, **task)],
            device=device,
        )

    requests = make_requests(rng, Event)
    gpu = DeploymentModule(make_model("cuda"), pkl)
    cpu = DeploymentModule(make_model("cpu"), pkl, device="cpu")
    answers, launches, report = serve(
        torch, gpu, cpu, requests, counters, dev, collate_events)
    emit({"phase": "serve", "dtype": "float32", "requests": report,
          "launches": {"knn": launches[0], "edgeconv": launches[1],
                       "edgeconv_bwd": launches[2],
                       "forwards": len(requests)},
          "seconds": round(time.perf_counter() - t0, 2)})

    t0 = time.perf_counter()
    gpu16 = DeploymentModule(make_model("cuda", "bfloat16"), pkl)
    launches16, report = serve_bf16(gpu16, requests, answers, counters)
    emit({"phase": "serve_bf16", "requests": report,
          "launches": {"knn": launches16[0], "edgeconv": launches16[1],
                       "edgeconv_bwd": launches16[2],
                       "forwards": len(requests)},
          "seconds": round(time.perf_counter() - t0, 2)})
    os.remove(pkl)
    os.rmdir(tmp)

    # 7. the training path through Trainer
    train_tree = trainable_tree(tree)

    def make_trainable(device, compute_dtype=None):
        model = make_model(
            device, compute_dtype, loss_function=LogCoshLoss(),
            target_labels=("total_energy",),
            transform_prediction_and_target=torch.log10)
        model.load_state_dict(params_from_jax(train_tree, model.state_dict()))
        return model

    t0 = time.perf_counter()
    batch = synthetic_batch(make_batch, np.random.default_rng(SEED))
    gpu_steps, report, launches_t = train(
        torch, make_trainable, Trainer, batch, counters, dev)
    emit({"phase": "train", "dtype": "float32", **report,
          "launches": dict(zip(("knn", "edgeconv", "edgeconv_bwd"), launches_t)),
          "seconds": round(time.perf_counter() - t0, 2)})

    t0 = time.perf_counter()
    report, launches_t16 = train_bf16(
        torch, make_trainable, Trainer, batch, counters, dev,
        gpu_steps["loss"][0])
    emit({"phase": "train_bf16", **report,
          "launches": dict(zip(("knn", "edgeconv", "edgeconv_bwd"), launches_t16)),
          "seconds": round(time.perf_counter() - t0, 2)})

    # 8. times
    t0 = time.perf_counter()
    times = kernel_times(torch, ops, rng, dev, peaks)
    times_bwd = bwd_times(torch, ops, rng, dev, peaks)
    serving = requests["b128_L128"]
    single = requests["one_event"]
    on_card = batch.to(dev)
    trainer = Trainer(make_trainable(dev))
    trainer16 = Trainer(make_trainable(dev, "bfloat16"))
    emit({
        "phase": "times", "card": smi, "kernels": times,
        "edgeconv_bwd_B128_L128": times_bwd,
        "serving_B128_L128": {
            "fp32_events_per_s": 128 / host_s(lambda: gpu(serving)),
            "bf16_events_per_s": 128 / host_s(lambda: gpu16(serving)),
            "single_event_p50_ms": 1e3 * host_s(lambda: gpu(single), runs=41),
        },
        "train_step_B128_L128": {"fp32": train_times(torch, trainer, on_card),
                                 "bf16": train_times(torch, trainer16, on_card)},
        "profile_fp32_B128_L128": device_profile(torch, lambda: gpu(serving)),
        "profile_train_fp32_B128_L128": device_profile(
            torch, lambda: trainer.train_step(on_card)),
        "seconds": round(time.perf_counter() - t0, 2),
    })

    # 9. the kernels line
    bwd32, bwd16 = times_bwd["H1_336_float32"], times_bwd["H1_336_bfloat16"]
    kernels = [
        dict(name="knn", route="cuda",
             source="graphnet_tpu_torch/csrc/knn.cu",
             replaces="graphnet_tpu/ops/knn_pallas.py:35",
             launches=launches[0], launches_per="serving forward: 5",
             max_abs_err=knn_err, **times["knn"], library_ms=None),
        dict(name="edgeconv_fwd", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:66",
             launches=launches[1], launches_per="serving forward: 4",
             max_abs_err=ec_err["float32"],
             **times["edgeconv_fwd"], library_ms=None),
        dict(name="edgeconv_fwd_bf16", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:66",
             launches=launches16[1], launches_per="serving forward: 4",
             max_abs_err=ec_err["bfloat16"],
             **times["edgeconv_fwd_bf16"], library_ms=None),
        dict(name="edgeconv_bwd", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv_bwd.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:116",
             launches=launches_t[2], launches_per="training step: 4",
             max_abs_err=bwd_err["float32"], **bwd32, library_ms=None),
        dict(name="edgeconv_bwd_bf16", route="cuda",
             source="graphnet_tpu_torch/csrc/edgeconv_bwd.cu",
             replaces="graphnet_tpu/ops/edgeconv_pallas.py:116",
             launches=launches_t16[2], launches_per="training step: 4",
             max_abs_err=bwd_err["bfloat16"], **bwd16, library_ms=None),
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
