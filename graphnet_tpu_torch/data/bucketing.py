"""Data-driven length buckets for the dense-padded layout (counterpart
of ``graphnet_tpu/data/bucketing.py``).

Every event pads to its length bucket, so padding is the layout's cost,
and each distinct bucket is one shape the kernels and the card's caches
see.  Given the event-length distribution and a bucket-count budget, a
dynamic program picks the buckets that minimise the padded node slots
(maximise the padding efficiency, valid slots / padded slots).
``LenMatchBatchSampler`` packs each batch tightly inside them.

Typical use::

    lengths = dataset.event_lengths()
    buckets = optimize_buckets(lengths, n_buckets=4)
    loader = DataLoader(dataset, buckets=buckets, ...)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def optimize_buckets(
    lengths: Sequence[int],
    n_buckets: int = 4,
    align: int = 16,
    max_length: int | None = None,
) -> Tuple[int, ...]:
    """Pick ``<= n_buckets`` bucket lengths minimising padded slots.

    Args:
        lengths: per-event node counts (any int sequence).
        n_buckets: the budget of distinct bucket lengths.
        align: buckets are rounded up to this multiple (16, the
            sampler's ``bucket_width``).
        max_length: optional hard cap; longer events truncate to it
            (the IceMixNodes subsampling escape hatch), and it becomes
            the largest bucket.

    Returns:
        sorted tuple of bucket lengths; the largest covers the longest
        (possibly capped) event.

    Exact via dynamic programming on the aligned candidate boundaries:
    ``cost(i, j)`` = events in ``(cand[i], cand[j]]`` × ``cand[j]``,
    ``dp[k][j]`` = min padded slots covering everything ≤ ``cand[j]``
    with ``k`` buckets where ``cand[j]`` is a bucket.  O(k·m²) for m
    distinct aligned lengths — m is a few hundred for real detectors.
    """
    arr = np.asarray(lengths, dtype=np.int64)
    if arr.size == 0:
        raise ValueError("no lengths given")
    if (arr <= 0).any():
        raise ValueError("lengths must be positive")
    if n_buckets < 1:
        raise ValueError("n_buckets must be >= 1")
    if align < 1:
        raise ValueError("align must be >= 1")
    if max_length is not None:
        arr = np.minimum(arr, max_length)
    # aligned candidate boundaries and event counts per candidate; the
    # max_length hard cap wins over alignment (a caller bounding the
    # compiled node axis must get exactly that bound)
    aligned = (arr + align - 1) // align * align
    if max_length is not None:
        aligned = np.minimum(aligned, max_length)
    cand, counts = np.unique(aligned, return_counts=True)
    m = len(cand)
    if n_buckets >= m:
        return tuple(int(c) for c in cand)
    csum = np.concatenate([[0], np.cumsum(counts)])  # events <= cand[j-1]
    candf = cand.astype(np.float64)
    # dp[k][j]: min padded slots covering candidates [0..j] using at
    # most k+1 buckets, with a bucket at cand[j].
    # par[k][j]: -2 = same j solved with k buckets (unused budget);
    #            i >= 0 = previous bucket at cand[i].
    dp = np.full((n_buckets, m), np.inf)
    par = np.full((n_buckets, m), -2, dtype=np.int64)
    dp[0] = candf * csum[1:]  # one bucket: everything pads to cand[j]
    for k in range(1, n_buckets):
        dp[k] = dp[k - 1]
        for j in range(1, m):
            # extend: previous bucket ends at cand[i], events in
            # (cand[i], cand[j]] pad to cand[j]
            ext = dp[k - 1, :j] + candf[j] * (csum[j + 1] - csum[1 : j + 1])
            i = int(np.argmin(ext))
            if ext[i] < dp[k, j]:
                dp[k, j] = ext[i]
                par[k, j] = i
    # backtrack from the largest candidate (always a bucket)
    buckets = [int(cand[m - 1])]
    k, j = n_buckets - 1, m - 1
    while k > 0:
        if par[k, j] == -2:
            k -= 1
        else:
            j = int(par[k, j])
            buckets.append(int(cand[j]))
            k -= 1
    return tuple(sorted(buckets))


def padding_efficiency(
    lengths: Sequence[int],
    buckets: Sequence[int],
) -> float:
    """Valid slots / padded slots if each event pads to its bucket
    (events beyond the largest bucket truncate to it — they contribute
    full slots).  Upper-bounds the live loader's measured
    ``DataLoader.padding_efficiency`` denominator per event; use it to
    compare bucket policies offline."""
    arr = np.asarray(lengths, dtype=np.int64)
    b = np.sort(np.asarray(buckets, dtype=np.int64))
    idx = np.searchsorted(b, arr)
    capped = np.minimum(arr, b[-1])
    padded = b[np.minimum(idx, len(b) - 1)]
    return float(capped.sum() / padded.sum())
