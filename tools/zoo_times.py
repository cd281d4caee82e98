#!/usr/bin/env python3
"""Serving time of each model of the pretrained zoo, or of GraphNeT's
other five backbones, on one NVIDIA GPU, with its device time by kernel.

    python3 tools/zoo_times.py [--runs N] [--profiled M] [--backbones]

Each of the 11 directories of ``configs/models/zoo`` as
``chip_smoke.py``'s serve_zoo phase serves it (its functions, so the
same inputs): the ``graph_definition.yml`` and ``model.yml`` built by
``load_model`` on the card, a GraphNeT-layout checkpoint with random
weights (``examples.port_pretrained.graphnet_state_dict``) ported by
``weight_port.port_state_dict`` (DynEdge heads scaled by
``calibrate_heads``), and one request of 8 raw events of 0-700 pulses
(``ZOO_LENGTHS``) through the graph definition, served by
``DeploymentModule``.  Prints the card's ``nvidia-smi`` name and power
limit, then one JSON line per model: the request's host ms (median of
``--runs``) and events/s, and over ``--profiled`` requests
(``torch.profiler``) the device ms a request, the device's idle share
and the top kernels.  With ``--backbones`` the same for the five
backbones of ``chip_smoke.py``'s serve_backbones phase
(``backbone_model``, its raw events and checkpoint), RNN_TITO also with
its NodeRNN's ms on the request's batch and the GRU's steps (the
longest sensor series).  Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def zoo_request_times(torch, cs, directory, rng, pool, runs, profiled):
    from graphnet_tpu_torch.data.dataloader import collate_events
    from graphnet_tpu_torch.deployment.deployment_module import (
        DeploymentModule,
    )
    from graphnet_tpu_torch.examples.port_pretrained import (
        graphnet_state_dict,
    )
    from graphnet_tpu_torch.utils.config import load_model
    from graphnet_tpu_torch.utils.weight_port import port_state_dict

    root = os.path.join(cs.ZOO_DIR, directory)
    graph_definition = load_model(os.path.join(root, "graph_definition.yml"))
    names = list(graph_definition._input_feature_names)
    events = [graph_definition(raw, names) for raw in cs.zoo_raw_pulses(
        rng, names, pool, cs.ZOO_LENGTHS)]
    model = load_model(os.path.join(root, "model.yml"), device="cuda",
                       seed=cs.SEED)
    model.load_state_dict(port_state_dict(model, graphnet_state_dict(model,
                                                                     rng)))
    if type(model.backbone).__name__ == "DynEdge":
        cs.calibrate_heads(torch, model, {"request": events}, collate_events)
    module = DeploymentModule(model, model.state_dict(), device="cuda")
    return {"model": directory,
            **request_times(torch, cs, module, events, runs, profiled)}


def request_times(torch, cs, module, events, runs, profiled):
    """A request's host ms and events/s, and its device profile."""
    seconds = cs.host_s(lambda: module(events), runs=runs, warmup=2)
    profile = cs.device_profile(torch, lambda: module(events), calls=profiled)
    return {
        "nodes": [e.n_pulses for e in events],
        "ms_per_request": seconds * 1e3,
        "events_per_s": len(events) / seconds,
        "device_ms_per_request": profile["device_ms"] / profiled,
        "wall_ms_per_request_profiled": profile["wall_ms"] / profiled,
        "device_idle_share": profile["device_idle_share"],
        "top": [dict(t, ms=t["ms"] / profiled, count=t["count"] / profiled)
                for t in profile["top"][:6]],
    }


def backbone_request_times(torch, cs, kind, rng, pool, runs, profiled,
                           device="cuda"):
    from graphnet_tpu_torch.data.dataloader import collate_events
    from graphnet_tpu_torch.deployment.deployment_module import (
        DeploymentModule,
    )
    from graphnet_tpu_torch.examples.port_pretrained import (
        graphnet_state_dict,
    )
    from graphnet_tpu_torch.utils.weight_port import port_state_dict

    model, gd = cs.backbone_model(kind, device)
    names = list(gd._input_feature_names)
    raws = (cs.zoo_raw_pulses(rng, names, pool, cs.ISEECUBE_LENGTHS)
            if kind == "ISeeCube" else
            [pool[rng.choice(len(pool), n, replace=False)]
             for n in cs.ZOO_LENGTHS])
    events = [gd(raw, names) for raw in raws]
    model.load_state_dict(port_state_dict(model, graphnet_state_dict(model,
                                                                     rng)))
    module = DeploymentModule(model, model.state_dict(), device=device)
    row = {"backbone": kind,
           **request_times(torch, cs, module, events, runs, profiled)}
    if kind == "RNNTITO":
        rnn = model.backbone.rnn
        batch = collate_events([e for e in events if e.n_pulses],
                               min_pulses=1).to(device)
        row["gru_steps"] = max(
            int(np.diff(np.flatnonzero(e.x[:, -1] > 0.5).tolist()
                        + [e.n_pulses]).max())
            for e in events if e.n_pulses)

        def node_rnn():
            with torch.inference_mode():
                rnn(batch)
            if batch.x.is_cuda:
                torch.cuda.synchronize()

        row["node_rnn_ms"] = cs.host_s(node_rnn, runs=runs, warmup=2) * 1e3
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--profiled", type=int, default=5)
    parser.add_argument("--backbones", action="store_true",
                        help="time the five backbones of serve_backbones, "
                        "not the zoo")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("zoo_times: no CUDA device")
    sys.path.insert(0, str(HERE))
    cs = load_chip_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    pool = cs.sqlite_pulse_pool()
    if args.backbones:
        rng = np.random.default_rng(cs.SEED + 17)
        for kind in cs.BACKBONE_LAUNCHES:
            row = backbone_request_times(torch, cs, kind, rng, pool,
                                         args.runs, args.profiled)
            print(json.dumps({**row, "card": smi}), flush=True)
        return
    rng = np.random.default_rng(cs.SEED + 16)
    for directory in cs.ZOO_LAUNCHES:
        row = zoo_request_times(torch, cs, directory, rng, pool, args.runs,
                                args.profiled)
        print(json.dumps({**row, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
