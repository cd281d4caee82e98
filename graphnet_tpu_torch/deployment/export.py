"""Serving artifacts: the inference forward exported, served without model
code (counterpart of ``graphnet_tpu/deployment/export.py``).

:func:`export_serving` traces the whole inference function (the graph
building, the backbone and the task heads, with the trained weights
held in the artifact) through ``torch.export``, once per served
``(batch, length)``, and saves each program with ``torch.export.save``
as ``b{B:04d}_l{L:05d}.pt2`` beside a ``serving.json``.
:class:`ExportedModel` serves those programs back with no model class:
it imports the port's kernel operators (:mod:`graphnet_tpu_torch.ops.
library`), which every program calls, and ``collate_events``, and
nothing of ``graphnet_tpu_torch.models``.

Where the JAX package lowers one artifact for several platforms, a
program here is traced on the device it serves on (``device``, the GPU
unless the caller asks for the CPU): a CUDA program launches the Hopper
kernels through the operators, a CPU program runs their plain versions,
and :class:`ExportedModel` raises where the artifact's device is
missing.  The programs are not lowered further (no
``run_decompositions``), so each kernel stays one operator node.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

# the programs call these operators: registered before any is loaded
import graphnet_tpu_torch.ops.edgeconv_cuda  # noqa: F401
import graphnet_tpu_torch.ops.flash_attention_cuda  # noqa: F401
import graphnet_tpu_torch.ops.knn_cuda  # noqa: F401
import graphnet_tpu_torch.ops.rel_flash_attention_cuda  # noqa: F401
from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.data.dataloader import collate_events
from graphnet_tpu_torch.device import DeviceLike, resolve_device
from graphnet_tpu_torch.models.graphs.graph_definition import Event

_META = "serving.json"
_VERSION = 1


class Predict(nn.Module):
    """The served function of a model: ``(x [B, L, D] float32, mask [B, L]
    bool, n_pulses [B] int32) -> [B, n_cols]`` float32, the graph-level
    tasks' inference outputs side by side."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, mask, n_pulses):
        batch = EventBatch(x=x, mask=mask, n_pulses=n_pulses)
        outputs = self.model(batch, inference=True)
        return torch.cat([pred.float() for pred, _ in outputs], dim=1)


def export_serving(
    model: nn.Module,
    path: str,
    nb_inputs: int,
    prediction_columns: Sequence[str],
    batch_sizes: Sequence[int] = (1, 8, 32, 128),
    lengths: Sequence[int] = (128,),
    device: DeviceLike = "cuda",
) -> dict:
    """Export the inference forward of ``model`` at every ``(B, L)`` of the
    grid into ``path``; returns the ``serving.json`` written.

    Args:
        model: a port ``StandardModel`` with graph-level tasks, on
            ``device``.
        path: output directory.
        nb_inputs: node-feature width D the model was trained on.
        prediction_columns: output column names, recorded in the metadata.
        batch_sizes: served batch sizes (requests pad up to the next one;
            larger requests are chunked by the largest).
        lengths: served padded lengths (the collate buckets).
        device: where the programs are traced and will serve.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if any(task.node_level for task in model.tasks):
        raise NotImplementedError(
            "export_serving serves graph-level tasks; a node-level task's "
            "output is per pulse"
        )
    on = {p.device for p in model.parameters()}
    if on != {dev}:
        raise ValueError(
            f"the model's parameters lie on {sorted(map(str, on))}; a program "
            f"is traced on the device it serves on ({dev}): move the model "
            "there first"
        )
    dtype = getattr(model.backbone, "compute_dtype", None) or "float32"
    predict = Predict(model)
    was_training = model.training
    model.eval()
    os.makedirs(path, exist_ok=True)
    shapes = []
    try:
        for L in sorted(set(int(x) for x in lengths)):
            for B in sorted(set(int(x) for x in batch_sizes)):
                args = (
                    torch.zeros((B, L, nb_inputs), device=dev),
                    torch.ones((B, L), dtype=torch.bool, device=dev),
                    torch.full((B,), L, dtype=torch.int32, device=dev),
                )
                t0 = time.perf_counter()
                with torch.no_grad():
                    program = torch.export.export(predict, args, strict=False)
                fname = f"b{B:04d}_l{L:05d}.pt2"
                torch.export.save(program, os.path.join(path, fname))
                shapes.append({"batch": B, "length": L, "file": fname,
                               "seconds": time.perf_counter() - t0})
    finally:
        model.train(was_training)
    meta = {
        "version": _VERSION,
        "nb_inputs": int(nb_inputs),
        "prediction_columns": list(prediction_columns),
        "device": str(dev),
        "dtype": str(dtype),
        "shapes": shapes,
    }
    tmp = os.path.join(path, _META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, os.path.join(path, _META))
    return meta


class ExportedModel:
    """Serve an :func:`export_serving` artifact, with no model code.

    Mirrors the call contract of :class:`~graphnet_tpu_torch.deployment.
    deployment_module.DeploymentModule` for graph-level tasks (events in,
    ``[n_events, n_cols]`` out, one row per input event, NaN rows for
    events with no pulse), so deployers can use either; requests are
    padded to the exported batch grid and chunked by its largest batch
    size.

    Args:
        path: directory written by :func:`export_serving`.
        truncate_long: events longer than the largest exported length
            raise by default (the live module would use more pulses);
            pass True to serve their first L pulses instead.

    ``programs`` maps each exported ``(B, L)`` to its loaded program,
    a callable ``(x, mask, n_pulses) -> [B, n_cols]`` on ``device``.
    """

    def __init__(self, path: str, truncate_long: bool = False):
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        if meta.get("version") != _VERSION:
            raise ValueError(
                f"unsupported artifact version {meta.get('version')!r}"
            )
        # raises where the device the artifact was traced on is missing:
        # a CUDA program never runs on the CPU
        self.device = resolve_device(meta["device"])
        self.truncate_long = truncate_long
        self.nb_inputs = meta["nb_inputs"]
        self.prediction_columns = meta["prediction_columns"]
        self.programs: Dict[Tuple[int, int], Callable] = {}
        for s in meta["shapes"]:
            program = torch.export.load(os.path.join(path, s["file"]))
            self.programs[(s["batch"], s["length"])] = program.module()
        self._batch_sizes = sorted({b for b, _ in self.programs})
        self._lengths = sorted({l for _, l in self.programs})

    def __call__(self, events: Union[Event, List[Event]]) -> np.ndarray:
        if isinstance(events, Event):
            events = [events]
        max_b = self._batch_sizes[-1]
        outs = [
            self._call_chunk(events[s:s + max_b])
            for s in range(0, len(events), max_b)
        ]
        if not outs:
            return np.zeros((0, len(self.prediction_columns)), np.float32)
        return np.concatenate(outs, axis=0)

    def _call_chunk(self, events: List[Event]) -> np.ndarray:
        max_len = self._lengths[-1]
        long = [e.n_pulses for e in events if e.n_pulses > max_len]
        if long and not self.truncate_long:
            raise ValueError(
                f"event with {max(long)} pulses exceeds the largest "
                f"exported length {max_len}; re-export with longer "
                "lengths= or opt into ExportedModel(truncate_long=True)"
            )
        # 0-pulse events get NaN rows (they cannot be collated); rows
        # stay aligned with the input events
        kept = [i for i, e in enumerate(events) if e.n_pulses >= 1]
        full = np.full(
            (len(events), len(self.prediction_columns)), np.nan, np.float32
        )
        if not kept:
            return full
        batch = collate_events(
            [events[i] for i in kept], buckets=self._lengths, min_pulses=1
        )
        if batch.num_features != self.nb_inputs:
            raise ValueError(
                f"events have {batch.num_features} features; artifact "
                f"was exported with nb_inputs={self.nb_inputs}"
            )
        n_real = batch.batch_size
        B = next(b for b in self._batch_sizes if b >= n_real)
        L = batch.max_length
        x = torch.zeros((B, L, self.nb_inputs), dtype=torch.float32)
        mask = torch.zeros((B, L), dtype=torch.bool)
        n_pulses = torch.zeros((B,), dtype=torch.int32)
        x[:n_real], mask[:n_real] = batch.x, batch.mask
        n_pulses[:n_real] = batch.n_pulses
        with torch.inference_mode():
            out = self.programs[(B, L)](
                x.to(self.device), mask.to(self.device),
                n_pulses.to(self.device))
        full[kept] = out[:n_real].cpu().numpy()
        return full
