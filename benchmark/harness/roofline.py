"""Arithmetic shared by the operators' roofline formulas
(``rooflines/<operator>.py``), and the share the metrics report.

A formula gets one operator call (:class:`~harness.trace.OpCall`, with
``n``, the valid pulses of each event of the batch the call belongs to,
and ``batch_length``, that batch's padded length) and the card's peaks,
and returns the least seconds the call's work needs: the larger of its
operations over their peak rates and its bytes, each input read and each
output written once, over the memory bandwidth.  Work is counted for the
valid rows only, what these inputs need."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np


def valid_rows(call) -> np.ndarray:
    """Each event's valid rows in this call's length frame: the batch's
    pulses, plus the rows the model put before them (the cls token, where
    the call's length exceeds the batch's), at most the call's length."""
    shape = call.shapes[0]
    L = int(shape[-2]) if len(shape) == 4 else int(shape[1])
    n = np.asarray(call.n, np.float64) + max(0, L - int(call.batch_length))
    return np.minimum(n, L)


def least(flop_terms, nbytes: float, peaks: Dict[str, float]) -> float:
    """The larger of the operations' time (``(flops, rate)`` terms, summed)
    and the bytes' time."""
    return max(sum(f / r for f, r in flop_terms), nbytes / peaks["bytes"])


def matmul_rate(call, peaks) -> float:
    """fp32 inputs run on the CUDA cores in full fp32; bf16 on the tensor
    cores."""
    return peaks["fp32"] if call.element_size(0) == 4 else peaks["bf16"]


def edges(call, idx_arg: int = 2) -> float:
    """Valid edges: ``min(k, n - 1)`` a valid pulse."""
    n = valid_rows(call)
    k = call.shapes[idx_arg][-1]
    return float((n * np.minimum(k, np.maximum(n - 1, 0))).sum())


def knn_flops(n: np.ndarray, dims: int) -> float:
    """About 10 fp32 operations a valid pair (12 with a fourth column)."""
    return (10.0 if dims == 3 else 12.0) * float((n * n).sum())


def attention_terms(call, per_pair: float, rows_io: int):
    """``(flops, bytes)`` of a flash call: ``per_pair * hd`` a (head, valid
    query, valid key); ``rows_io`` head rows of q's dtype read or written
    once a valid row, with two fp32 scalars a row (lse, delta)."""
    B, H, L, hd = call.shapes[0]
    n = valid_rows(call)
    el = call.element_size(0)
    flops = per_pair * hd * H * float((n * n).sum())
    nbytes = float(n.sum()) * H * (rows_io * hd * el + 2 * 4) + B * L
    return flops, nbytes


def share(calls: Iterable, formulas: Callable[[str], Optional[object]],
          peaks: Dict[str, float]) -> Optional[float]:
    """Percent: the calls' summed least seconds over their summed device
    seconds (calls with no device time attributed are left out); ``None``
    where no call has any."""
    least_s = device_s = 0.0
    for call in calls:
        if call.device_us <= 0.0:
            continue
        least_s += formulas(call.name).least_seconds(call, peaks)
        device_s += call.device_us * 1e-6
    return None if device_s == 0.0 else 100.0 * least_s / device_s
