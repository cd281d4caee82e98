"""Pooling and grouping (counterpart of ``graphnet_tpu/models/
components/pool.py``): GraphNeT's pool names over the port's masked
reductions of padded batches, the group-by of pulses into DOMs or PMTs
on the host (numpy), and segment reductions over cluster ids on the
device."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from graphnet_tpu_torch.ops.gather_reduce import (
    masked_max,
    masked_mean,
    masked_min,
    masked_std,
    masked_sum,
)

# GraphNeT's names (dense-padded semantics)
min_pool = masked_min
max_pool = masked_max
sum_pool = masked_sum
avg_pool = masked_mean
std_pool = masked_std


def group_by_np(x: np.ndarray, columns: Sequence[int]) -> np.ndarray:
    """A cluster index a row, one for each unique combination of
    ``columns`` (in sorted order of the combinations)."""
    _, inverse = np.unique(x[:, list(columns)], axis=0, return_inverse=True)
    return inverse


def group_pulses_to_dom(x: np.ndarray, features: List[str]) -> np.ndarray:
    """Pulses grouped by DOM (``dom_x``, ``dom_y``, ``dom_z``)."""
    cols = [features.index(c) for c in ("dom_x", "dom_y", "dom_z")]
    return group_by_np(x, cols)


def group_pulses_to_pmt(x: np.ndarray, features: List[str]) -> np.ndarray:
    """Pulses grouped by PMT (the DOM and ``pmt_number`` where present)."""
    cols = [features.index(c)
            for c in ("dom_x", "dom_y", "dom_z", "pmt_number") if c in features]
    return group_by_np(x, cols)


def sum_pool_and_distribute(
    x: torch.Tensor, cluster: torch.Tensor, num_clusters: int
) -> torch.Tensor:
    """Features summed within clusters, the sums given back to every
    member: ``x [N, D]``, ``cluster [N]`` ids below ``num_clusters``."""
    return segment_pool(x, cluster, num_clusters, "sum")[cluster]


def segment_pool(
    x: torch.Tensor,
    cluster: torch.Tensor,
    num_clusters: int,
    aggr: str = "mean",
) -> torch.Tensor:
    """Reduction of ``x [N, ...]`` over the cluster ids ``cluster [N]``
    (``"sum"``/``"add"``, ``"mean"``, ``"min"``, ``"max"``).  An empty
    cluster is 0 for the sum and the mean, and the reduction's identity
    for min and max (``inf`` / ``-inf``, an integer dtype's largest /
    lowest value), as ``jax.ops.segment_min`` / ``segment_max`` give
    it."""
    cluster = cluster.long()
    shape = (num_clusters,) + tuple(x.shape[1:])
    if aggr in ("sum", "add", "mean"):
        s = torch.zeros(shape, dtype=x.dtype, device=x.device
                        ).index_add_(0, cluster, x)
        if aggr != "mean":
            return s
        n = torch.zeros(num_clusters, dtype=x.dtype, device=x.device).index_add_(
            0, cluster, torch.ones_like(cluster, dtype=x.dtype)).clamp_min(1.0)
        return s / n.reshape((num_clusters,) + (1,) * (x.dim() - 1))
    if aggr in ("min", "max"):
        if x.dtype.is_floating_point:
            fill = float("inf") if aggr == "min" else float("-inf")
        else:
            info = torch.iinfo(x.dtype)
            fill = info.max if aggr == "min" else info.min
        index = cluster.reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
        return torch.full(shape, fill, dtype=x.dtype, device=x.device
                          ).scatter_reduce(0, index, x, "amin" if aggr == "min"
                                           else "amax", include_self=True)
    raise ValueError(f"unknown aggregation {aggr!r}")
