"""What the examples share: the ``--device`` and ``--seed`` arguments,
a prediction table and a weight table printed without pandas (which the
GPU host may lack), and a copy of a database for the weight fitters to
write into."""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np


def add_device_arguments(parser, seed: int = 0):
    """``--device`` (``cuda`` by default) and ``--seed``, the training
    loader's shuffle seed (the JAX examples' 0 by default)."""
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=seed,
                        help="seed of the training loader's shuffle")
    return parser


def prediction_table(trainer, loader, attributes: Sequence[str] = ()):
    """``(columns, rows)``: the model's predictions over ``loader`` (one
    row an event) and the truth ``attributes`` beside them."""
    preds = np.concatenate(trainer.predict(loader), axis=1)
    columns = list(trainer.model.prediction_labels) + list(attributes)
    if attributes:
        truth = np.stack([
            np.concatenate([b.labels[a].cpu().numpy().reshape(-1)
                            for b in loader])
            for a in attributes], axis=1)
        preds = np.concatenate([preds, truth], axis=1)
    return columns, preds


def print_predictions(trainer, loader, attributes: Sequence[str] = (),
                      rows: int = 5) -> np.ndarray:
    """Print the head of :func:`prediction_table`; returns the table."""
    columns, table = prediction_table(trainer, loader, attributes)
    print("  ".join(f"{c:>16}" for c in columns))
    for row in table[:rows]:
        print("  ".join(f"{v:>16.6g}" for v in row))
    print(f"[{len(table)} rows x {len(columns)} columns]")
    return table


def copy_database(path: str, output: Optional[str] = None) -> str:
    """A copy of the database at ``output`` (a new temporary file by
    default), for the fitters to write their tables into."""
    if output is None:
        fd, output = tempfile.mkstemp(suffix=".db")
        os.close(fd)
    shutil.copy(path, output)
    return output


def print_table(table: Dict[str, np.ndarray], rows: int = 5) -> None:
    """The head of a weight table (a dict of columns), without pandas."""
    columns: Sequence[str] = list(table)
    print("  ".join(f"{c:>32}" for c in columns))
    for i in range(min(rows, len(table[columns[0]]))):
        print("  ".join(f"{table[c][i]:>32.6g}" for c in columns))
    print(f"[{len(table[columns[0]])} rows x {len(columns)} columns]")
