"""Learning-rate schedule, early stopping and a JSON-lines metric logger
(counterpart of ``graphnet_tpu/training/callbacks.py``).

The schedule is a plain function of the optimiser step; the Trainer
turns it into a ``torch.optim.lr_scheduler.LambdaLR``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Sequence

import numpy as np

Schedule = Callable[[int], float]


def piecewise_linear_schedule(
    base_lr: float,
    milestones: Sequence[int],
    factors: Sequence[float],
) -> Schedule:
    """Learning rate = ``base_lr * interp(step, milestones, factors)``:
    linear between milestones, constant outside them.  The canonical
    DynEdge schedule is factors ``[1e-2, 1, 1e-2]`` at milestones
    ``[0, steps_per_epoch / 2, steps_per_epoch * epochs]``.

    Computed in float32, as the JAX package's schedule is.
    """
    ms = np.asarray(milestones, np.float32)
    fs = np.asarray(factors, np.float32)

    def schedule(step: int) -> float:
        factor = np.float32(np.interp(np.float32(step), ms, fs))
        return float(np.float32(base_lr) * factor)

    return schedule


class EarlyStopping:
    """Track a validation metric; signal a stop after ``patience``
    epochs without an improvement of more than ``min_delta``."""

    def __init__(self, patience: int = 5, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best: float = np.inf
        self.best_epoch: int = -1
        self.counter: int = 0

    def update(self, value: float, epoch: int) -> bool:
        """Record a validation metric; returns True if this is a new best."""
        if value < self.best - self.min_delta:
            self.best = value
            self.best_epoch = epoch
            self.counter = 0
            return True
        self.counter += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.counter >= self.patience


class JSONLinesLogger:
    """Metric logger for ``Trainer(metric_logger=...)``: one JSON object
    per ``log_metrics`` call (``step``, ``time`` and the metrics) appended
    to a ``.jsonl`` file::

        logger = JSONLinesLogger("runs/exp1/metrics.jsonl")
        Trainer(model, metric_logger=logger).fit(loader)
        records = logger.read()

    A fresh logger truncates the file; ``resume=True`` (for a run that
    resumes with ``fit(resume=True)``) keeps its records and appends.
    """

    def __init__(self, path: str, resume: bool = False):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        open(path, "a" if resume else "w").close()

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        rec: Dict[str, Any] = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def read(self) -> List[Dict[str, Any]]:
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
