"""Synthetic Prometheus SQLite databases for loader and end-to-end runs
(counterpart of ``graphnet_tpu/datasets/synthetic.py``, row for row the
same database from the same seed).

The bundled example database (``data/examples/sqlite/prometheus/
prometheus-events.db``, 50 events) is too small to exercise the input
pipeline at production batch sizes: an epoch is two batches.
``generate_prometheus_db`` bootstrap-resamples it into a database of any
size with the same schema, column statistics and pulse-length
distribution.

Generation is deterministic in ``seed``: events are drawn i.i.d. from
the 50 source events, pulse times get small Gaussian jitter (1 ns) and
each event's ``mc_truth`` row is copied verbatim under a fresh
``event_no``.  Pulse counts (and hence padding behaviour) exactly follow
the source distribution (3-99 pulses, mean ~37).
"""

from __future__ import annotations

import os
import sqlite3
import tempfile
from typing import Optional

import numpy as np

from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA


def generate_prometheus_db(
    path: str,
    n_events: int = 2000,
    seed: int = 0,
    source: Optional[str] = None,
    pulsemap: str = "total",
    truth_table: str = "mc_truth",
) -> str:
    """Write a synthetic ``n_events``-event Prometheus DB to ``path``.

    Bootstrap-resamples events from ``source`` (default: the bundled
    50-event example DB).  Returns ``path``.  Overwrites any existing
    file at ``path``.
    """
    source = source or EXAMPLE_SQLITE_DATA
    rng = np.random.default_rng(seed)

    src = sqlite3.connect(f"file:{source}?mode=ro", uri=True)
    try:
        pulse_cols = [
            r[1] for r in src.execute(f"PRAGMA table_info({pulsemap})")
        ]
        truth_cols = [
            r[1] for r in src.execute(f"PRAGMA table_info({truth_table})")
        ]
        ev_col_p = pulse_cols.index("event_no")
        ev_col_t = truth_cols.index("event_no")
        t_col = pulse_cols.index("t") if "t" in pulse_cols else None

        pulses_by_event: dict = {}
        for row in src.execute(f"SELECT * FROM {pulsemap}"):
            pulses_by_event.setdefault(row[ev_col_p], []).append(list(row))
        truth_by_event = {
            row[ev_col_t]: list(row)
            for row in src.execute(f"SELECT * FROM {truth_table}")
        }
    finally:
        src.close()

    source_events = sorted(truth_by_event)
    picks = rng.integers(0, len(source_events), size=n_events)

    if os.path.exists(path):
        os.remove(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    dst = sqlite3.connect(path)
    try:
        dst.execute(
            f"CREATE TABLE {pulsemap} ({', '.join(pulse_cols)})"
        )
        dst.execute(
            f"CREATE TABLE {truth_table} "
            f"({', '.join(truth_cols)}, PRIMARY KEY (event_no))"
        )
        pulse_rows = []
        truth_rows = []
        for new_no, pick in enumerate(picks):
            src_no = source_events[pick]
            trow = list(truth_by_event[src_no])
            trow[ev_col_t] = new_no
            truth_rows.append(trow)
            src_pulses = pulses_by_event[src_no]
            jitter = (
                rng.normal(0.0, 1.0, size=len(src_pulses))
                if t_col is not None
                else None
            )
            for i, prow in enumerate(src_pulses):
                prow = list(prow)
                prow[ev_col_p] = new_no
                if t_col is not None:
                    prow[t_col] = float(prow[t_col]) + float(jitter[i])
                pulse_rows.append(prow)
        ph = ", ".join("?" * len(pulse_cols))
        th = ", ".join("?" * len(truth_cols))
        dst.executemany(
            f"INSERT INTO {pulsemap} VALUES ({ph})", pulse_rows
        )
        dst.executemany(
            f"INSERT INTO {truth_table} VALUES ({th})", truth_rows
        )
        dst.execute(
            f"CREATE INDEX event_no_{pulsemap} ON {pulsemap} (event_no)"
        )
        dst.commit()
    finally:
        dst.close()
    return path


def cached_prometheus_db(
    n_events: int = 2000, seed: int = 0, cache_dir: Optional[str] = None
) -> str:
    """The path of a cached synthetic database, generated at first use
    in ``cache_dir`` (the temporary directory by default).  It is
    written under a temporary name and renamed, so a concurrent reader
    never sees half of it."""
    cache_dir = cache_dir or tempfile.gettempdir()
    path = os.path.join(
        cache_dir, f"graphnet_tpu_synth_prometheus_{n_events}_{seed}.db"
    )
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        generate_prometheus_db(tmp, n_events=n_events, seed=seed)
        os.replace(tmp, path)
    return path
