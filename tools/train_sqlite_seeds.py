#!/usr/bin/env python3
"""chip_smoke.py's train_sqlite phase over many shuffle seeds, on one
NVIDIA GPU, and what a failing seed's step-1 gradient is made of.

    python3 tools/train_sqlite_seeds.py [--runs N | --seeds S [S ...]]
                                        [--out chiprun_out]
                                        [--contributions PARAM ...]

Builds the kernels, then runs ``chip_smoke.train_sqlite`` (the training
example's path: the bundled SQLite database, the datamodule's loaders,
``Trainer.fit`` of the full-width DynEdge with ``FUSE_CONV_KNN`` on;
step 1 held against the CPU fed the card's adjacency) once per seed: N
seeds drawn anew (default 20) or the seeds given.  One JSON line per
seed: passed or the error, the worst step-1 gradient error over its
parameter's max and that parameter.

A failing seed leaves its evidence under ``--out`` (the step-1 batch,
the card's adjacency, both devices' gradients: ``train_sqlite``).  For
it the tool then splits the step-1 gradient of each failing parameter
(and of each ``--contributions`` parameter, for every seed, failing or
not: the step-1 batch drawn again from the seed) into the events'
contributions, on the card (the fused kernels, which rebuild the same
adjacency) and on the CPU (fed the card's adjacency, the fused kernel
off), from the gradient of the loss with respect to the energy head's
output, one backward pass an event, and prints:

* ``cancellation``: the sum's max over the max of the summed
  magnitudes (sum over events of |contribution|), on the CPU: how far
  the events' contributions cancel;
* ``event_rel_err``: per event, the card's contribution against the
  CPU's, over that event's max;
* ``sum_rel_err_to_magnitudes``: the two sums' difference over the
  summed magnitudes' max; and ``sum_rel_err_to_max`` over the sum's
  max, which is what the phase holds to 1e-3.

Contributions that agree event by event to rounding, with a sum that
cancels to a small share of its terms, say the sum's error is the
events' rounding, not a fault; one event far off says a kernel gives
that event another gradient.  Prints the card's ``nvidia-smi`` name and
power limit first.  Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from dataclasses import replace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from graphnet_tpu_torch.kernels import build  # noqa: E402
from graphnet_tpu_torch.models.components import layers  # noqa: E402
from graphnet_tpu_torch.ops.edgeconv_cuda import (  # noqa: E402
    fused_edgeconv_bwd,
    fused_edgeconv_knn,
)
from graphnet_tpu_torch.ops.knn_cuda import knn_graph_cuda  # noqa: E402
from graphnet_tpu_torch.training.trainer import Trainer  # noqa: E402

# the phase's launches (kNN, row 3, row 4) a step and a validation
# forward with FUSE_CONV_KNN on
COUNTERS = (knn_graph_cuda, fused_edgeconv_bwd, fused_edgeconv_knn)
STEP, FWD = [1, 4, 4], [1, 0, 4]


def event_contributions(model, batch, names):
    """Per event e of ``batch``, its term of the gradient of
    ``model.loss_from_batch`` for each parameter in ``names``: the loss
    reaches every parameter through the energy head's output y, so the
    term is the backward of y with the loss's gradient kept at row e
    alone.  Returns {name: [B, *shape] float64 on the CPU}."""
    head = []
    hook = model.tasks_0.affine.register_forward_hook(
        lambda mod, args, out: head.append(out))
    model.train()
    loss = model.loss_from_batch(model(batch), batch)
    hook.remove()
    y = head[-1]
    (g,) = torch.autograd.grad(loss, y, retain_graph=True)
    params = dict(model.named_parameters())
    out = {n: [] for n in names}
    for e in range(y.shape[0]):
        ge = torch.zeros_like(g)
        ge[e] = g[e]
        grads = torch.autograd.grad(y, [params[n] for n in names], ge,
                                    retain_graph=True, allow_unused=True)
        for n, gr in zip(names, grads):
            out[n].append(torch.zeros(params[n].shape, dtype=torch.float64)
                          if gr is None else gr.detach().double().cpu())
    return {n: torch.stack(v) for n, v in out.items()}


def analyse(seed, names, dev, evidence=None):
    """The events' contributions on both devices for ``seed``'s step-1
    batch: from a failing run's evidence, or drawn again (the first
    batch of the seeded train loader) with the card's adjacency."""
    if evidence is not None:
        ev = torch.load(evidence, weights_only=False)
        step1 = ev["batch"]
    else:
        ev = None
        step1 = next(iter(cs.sqlite_example("cpu", seed)[0].train_dataloader()))
    layers.FUSE_CONV_KNN = True
    try:
        card = cs.sqlite_example(dev, seed)[1]
        store = []
        handles = cs.record_adjacency(card, store)
        c_card = event_contributions(card, step1.to(dev), names)
        for h in handles:
            h.remove()
    finally:
        layers.FUSE_CONV_KNN = False
    graphs = [(i.cpu(), m.cpu()) for i, m in store]
    same_graphs = ev is None or all(
        torch.equal(i, gi) and torch.equal(m, gm)
        for (i, m), (gi, gm) in zip(graphs, ev["graphs"]))
    cpu = cs.sqlite_example("cpu", seed)[1]
    hooks = cs.feed_adjacency(cpu, graphs, "cpu")
    batch = replace(step1, edges=graphs[0][0], edge_mask=graphs[0][1])
    c_cpu = event_contributions(cpu, batch, names)
    for h in hooks:
        h.remove()
    report = {"seed": seed, "card_adjacency_rebuilt": same_graphs,
              "events": int(batch.x.shape[0]), "params": {}}
    for n in names:
        a, b = c_card[n], c_cpu[n]
        mag = float(b.abs().sum(0).max())
        s_a, s_b = a.sum(0), b.sum(0)
        ev_max = b.flatten(1).abs().amax(1).clamp_min(1e-300)
        ev_err = (a - b).flatten(1).abs().amax(1) / ev_max
        report["params"][n] = {
            "cancellation": float(s_b.abs().max()) / mag if mag else None,
            "event_rel_err": ev_err.tolist(),
            "worst_event": int(ev_err.argmax()),
            "sum_rel_err_to_magnitudes":
                float((s_a - s_b).abs().max()) / mag if mag else None,
            "sum_rel_err_to_max":
                float((s_a - s_b).abs().max() / s_b.abs().max()),
        }
        if ev is not None:
            report["params"][n]["phase_grad_rel_err"] = float(
                (ev["grads_card"][n] - ev["grads_cpu"][n]).abs().max()
                / ev["grads_cpu"][n].abs().max())
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--seeds", type=int, nargs="*")
    parser.add_argument("--out", default="chiprun_out")
    parser.add_argument("--contributions", nargs="*", default=[])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_sqlite_seeds: no CUDA device is available",
              file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    build.build(["knn", "edgeconv", "edgeconv_knn", "edgeconv_bwd"])
    dev = torch.device("cuda")
    seeds = args.seeds or [cs.shuffle_seed() for _ in range(args.runs)]
    failing = []
    for seed in seeds:
        layers.FUSE_CONV_KNN = True
        try:
            rep, _ = cs.train_sqlite(torch, cs.sqlite_example, Trainer,
                                     COUNTERS, STEP, FWD, dev, seed,
                                     evidence=args.out)
            line = {"seed": seed, "passed": True,
                    "max_grad_rel_err_step1":
                        rep["max_grad_rel_err_step1_card_adjacency"],
                    "worst_grad_param": rep["worst_grad_param"]}
        except AssertionError as err:
            line = {"seed": seed, "passed": False, "error": str(err)[:300]}
            stem = os.path.join(args.out, f"train_sqlite_seed{seed}")
            if os.path.exists(stem + ".json"):
                with open(stem + ".json") as f:
                    errs = json.load(f)
                worst = max(errs["grad_rel_err"], key=errs["grad_rel_err"].get)
                line.update(max_grad_rel_err_step1=errs["grad_rel_err"][worst],
                            worst_grad_param=worst, failed=errs["failed"])
                failing.append((seed, stem + ".pt", errs["failed"]))
        finally:
            layers.FUSE_CONV_KNN = False
        print(json.dumps(line), flush=True)
        if args.contributions:
            print(json.dumps({"contributions": analyse(
                seed, args.contributions, dev)}), flush=True)
    for seed, path, names in failing:
        print(json.dumps({"contributions": analyse(seed, names, dev, path)}),
              flush=True)
    print(json.dumps({"seeds": len(seeds), "failed": len(failing)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
