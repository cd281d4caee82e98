"""What the metric readers (``metrics/<name>.py``) compute from a run's
:class:`~harness.cells.Record`; each returns ``None`` where the run has
nothing to read, or where a ``kind`` is given and the run is not of it
(``"train"`` or ``"serve"``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from harness.peaks import dtype_peak
from harness.roofline import share


def events_per_s(rec, kind: str) -> Optional[float]:
    """Events stepped or answered a second over the window, host clock."""
    return rec.events / rec.window_s if rec.kind == kind else None


def peak_gb(rec, kind: str) -> Optional[float]:
    """The window's peak device memory, 1e9 bytes."""
    return rec.window_peak_bytes / 1e9 if rec.kind == kind else None


def p95_ms(rec, kind: str) -> Optional[float]:
    """The 95th percentile of every request's milliseconds, send to answer."""
    if rec.kind != kind or not rec.latencies_s:
        return None
    return float(np.percentile(np.asarray(rec.latencies_s) * 1e3, 95))


def padding_pct(rec) -> Optional[float]:
    """Percent of the padded pulse slots of every call that hold a pulse."""
    if not rec.slots:
        return None
    return 100.0 * sum(v for v, _ in rec.slots) / sum(t for _, t in rec.slots)


def loader_ms(rec) -> Optional[float]:
    """Host milliseconds in the DataLoader's ``next()`` a batch."""
    if rec.kind != "train" or not rec.calls:
        return None
    return 1e3 * rec.loader_s / rec.calls


def mfu_pct(rec) -> Optional[float]:
    """Percent of the dtype's peak: the model FLOPs of the calls in the
    untraced part of a traced window over the seconds they took."""
    if rec.flops_s <= 0 or rec.flops <= 0:
        return None
    return 100.0 * rec.flops / (rec.flops_s * dtype_peak(rec.peaks, rec.dtype))


def roofline_pct(rec) -> Optional[float]:
    """Percent: the port's operator calls' least seconds over their device
    seconds, in the traced stretch."""
    if rec.trace is None:
        return None
    return share(rec.trace.ops, rec.formulas, rec.peaks)


def idle_pct(rec) -> Optional[float]:
    """Percent of the traced stretch with no activity on the device."""
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
