"""Host-side (numpy) helpers of graph construction (counterpart of
``graphnet_tpu/models/graphs/utils.py``): lexicographic sorting of
pulses by sensor, the per-sensor gather and percentile summary of
:class:`~graphnet_tpu_torch.models.graphs.nodes.PercentileClusters`,
and the ice-transparency interpolators.

The ice table is read from ``ice_transparency.txt`` beside this module:
a plain-text copy of ``data/ice_properties/ice_transparency.parquet``
(110 rows of depth, scattering and absorption length, each float written
with ``repr``, so it reads back bit for bit), because pandas is not a
dependency of the port.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

ICE_TRANSPARENCY_TABLE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "ice_transparency.txt"
)


def lex_sort(x: np.ndarray, cluster_columns: List[int]) -> np.ndarray:
    """The rows of ``x`` sorted lexicographically by ``cluster_columns``,
    the last listed column the slowest (``np.lexsort``'s order; stable,
    so rows of one key keep their order)."""
    keys = tuple(x[:, c] for c in cluster_columns)
    return x[np.lexsort(keys), :]


def identify_indices(
    feature_names: List[str], cluster_on: List[str]
) -> Tuple[List[int], List[int], List[str]]:
    """``(cluster column indices, summary column indices, summary
    column names)``: the columns of ``cluster_on``, and the others in
    their order."""
    summ_names = [f for f in feature_names if f not in cluster_on]
    cluster_idx = [feature_names.index(c) for c in cluster_on]
    summ_idx = [feature_names.index(c) for c in summ_names]
    return cluster_idx, summ_idx, summ_names


def gather_cluster_sequence(
    x: np.ndarray, feature_idx: int, cluster_columns: List[int]
) -> Tuple[np.ndarray, int, np.ndarray]:
    """The values of column ``feature_idx`` gathered per cluster (rows of
    one key of ``cluster_columns``), clusters in :func:`lex_sort` order.

    Returns ``(array [n_clusters, n_key_cols + max_count], offset,
    counts)``: each row the cluster's key, then its values, NaN-padded;
    ``offset`` the number of key columns; ``counts`` the values a
    cluster has.
    """
    x = lex_sort(x, cluster_columns)
    keys = x[:, cluster_columns]
    # the sorted rows hold each key contiguously: the boundaries are the
    # rows whose key differs from the row before
    change = np.any(keys[1:] != keys[:-1], axis=1)
    boundaries = np.concatenate([[0], np.nonzero(change)[0] + 1, [len(x)]])
    counts = np.diff(boundaries).astype(int)
    n_clusters = len(counts)
    unique_keys = keys[boundaries[:-1]]
    width = counts.max() if n_clusters else 0
    array = np.full((n_clusters, len(cluster_columns) + width), np.nan)
    array[:, : len(cluster_columns)] = unique_keys
    offset = len(cluster_columns)
    for k in range(n_clusters):
        seg = x[boundaries[k] : boundaries[k + 1], feature_idx]
        array[k, offset : offset + counts[k]] = seg
    return array, offset, counts


def cluster_summarize_with_percentiles(
    x: np.ndarray,
    summarization_indices: List[int],
    cluster_indices: List[int],
    percentiles: List[int],
    add_counts: bool,
) -> np.ndarray:
    """One row per cluster of ``cluster_indices``: the cluster's key, the
    ``percentiles`` of each summary column over its rows
    (``np.nanpercentile``), and with ``add_counts`` log10 of its row
    count."""
    if not summarization_indices:
        raise ValueError("no summarization columns")
    blocks = []
    array = None
    for feature_idx in summarization_indices:
        summarized, offset, counts = gather_cluster_sequence(
            x, feature_idx, cluster_indices
        )
        if array is None:
            array = summarized[:, :offset]
        pct = np.nanpercentile(summarized[:, offset:], percentiles, axis=1).T
        blocks.append(pct)
    out = np.concatenate([array] + blocks, axis=1)
    if add_counts:
        out = np.concatenate([out, np.log10(counts).reshape(-1, 1)], axis=1)
    return out


def ice_transparency_table() -> np.ndarray:
    """The ice table, ``[110, 3]`` float64: depth, scattering length,
    absorption length."""
    return np.loadtxt(ICE_TRANSPARENCY_TABLE, dtype=np.float64, ndmin=2)


def ice_transparency(
    z_offset: Optional[float] = None, z_scaling: Optional[float] = None
) -> Tuple[Callable, Callable]:
    """Interpolators of the normalised IceCube scattering and absorption
    lengths over the normalised depth ``(depth + z_offset) / z_scaling``
    (defaults -1950 and 500: pulses with z scaled by 1/500).  Each length
    is robust-scaled: its median subtracted, divided by its interquartile
    range."""
    from scipy.interpolate import interp1d

    table = ice_transparency_table()
    z_offset = z_offset if z_offset is not None else -1950.0
    z_scaling = z_scaling if z_scaling is not None else 500.0
    z_norm = (table[:, 0] + z_offset) / z_scaling

    def robust(col: np.ndarray) -> np.ndarray:
        med = np.median(col)
        q1, q3 = np.percentile(col, [25, 75])
        return (col - med) / (q3 - q1)

    scatt = robust(table[:, 1])
    absorb = robust(table[:, 2])
    return interp1d(z_norm, scatt), interp1d(z_norm, absorb)
