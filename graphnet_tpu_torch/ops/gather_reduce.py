"""Neighbour gather and masked reductions on dense-padded graphs
(counterpart of ``graphnet_tpu/ops/gather_reduce.py``).

"Scatter over batch ids" is a masked reduction over the L axis, and
"scatter over edges" a reduction over the regular neighbour axis k.  A
node or event with nothing valid to reduce gives 0.
"""

from __future__ import annotations

import torch

_NEG = -1e30
_POS = 1e30


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[B, L, D] gathered at [B, Lq, k] -> [B, Lq, k, D]`` (``Lq`` is
    ``L``, or fewer query rows indexing all ``L``: a node shard's)."""
    B, _, D = x.shape
    L, k = idx.shape[1], idx.shape[2]
    flat = idx.reshape(B, L * k, 1).long().expand(B, L * k, D)
    return torch.gather(x, 1, flat).reshape(B, L, k, D)


def edge_reduce(
    msgs: torch.Tensor, edge_mask: torch.Tensor, aggr: str
) -> torch.Tensor:
    """Reduce messages ``[B, L, k, D]`` over the neighbour axis.

    ``aggr`` in {"sum"/"add", "mean", "max", "min"}.  Masked edges are
    ignored; nodes with no valid edge give 0.
    """
    m = edge_mask[..., None]
    if aggr in ("sum", "add"):
        return torch.where(m, msgs, 0.0).sum(dim=2)
    if aggr == "mean":
        s = torch.where(m, msgs, 0.0).sum(dim=2)
        n = edge_mask.sum(dim=2, keepdim=True)
        return s / n.clamp_min(1)
    if aggr == "max":
        r = torch.where(m, msgs, _NEG).amax(dim=2)
        return torch.where(edge_mask.any(dim=2, keepdim=True), r, 0.0)
    if aggr == "min":
        r = torch.where(m, msgs, _POS).amin(dim=2)
        return torch.where(edge_mask.any(dim=2, keepdim=True), r, 0.0)
    raise ValueError(f"unknown aggregation {aggr!r}")


def masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[B, L, D], [B, L] -> [B, D]``."""
    return torch.where(mask[..., None], x, 0.0).sum(dim=1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum(dim=1, keepdim=True)
    return masked_sum(x, mask) / n.clamp_min(1)


def masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    r = torch.where(mask[..., None], x, _NEG).amax(dim=1)
    return torch.where(mask.any(dim=1, keepdim=True), r, 0.0)


def masked_min(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    r = torch.where(mask[..., None], x, _POS).amin(dim=1)
    return torch.where(mask.any(dim=1, keepdim=True), r, 0.0)


def masked_std(
    x: torch.Tensor, mask: torch.Tensor, eps: float = 0.0
) -> torch.Tensor:
    """Population std per event."""
    mean = masked_mean(x, mask)
    d = torch.where(mask[..., None], x - mean[:, None, :], 0.0)
    n = mask.sum(dim=1, keepdim=True).clamp_min(1)
    return torch.sqrt((d * d).sum(dim=1) / n + eps)


POOLS = {
    "sum": masked_sum,
    "add": masked_sum,
    "mean": masked_mean,
    "max": masked_max,
    "min": masked_min,
    "std": masked_std,
}


def sharded_pool(x: torch.Tensor, mask: torch.Tensor, scheme: str,
                 axis) -> torch.Tensor:
    """One pooling scheme of node-sharded events (``x [B, Ls, D]``, this
    process's rows) reduced across the ``graph`` axis ``axis``
    (:class:`~graphnet_tpu_torch.parallel.graph_sharding.GraphAxis`):
    sums, means over the whole event's count, and max / min with the
    gradient on the process holding the extreme."""
    if scheme in ("sum", "add"):
        return axis.sum(masked_sum(x, mask))
    n = axis.sum_const(mask.sum(dim=1, keepdim=True).to(x.dtype))
    if scheme == "mean":
        return axis.sum(masked_sum(x, mask)) / n.clamp_min(1)
    if scheme in ("max", "min"):
        largest = scheme == "max"
        r = torch.where(mask[..., None], x, _NEG if largest else _POS)
        r = r.amax(dim=1) if largest else r.amin(dim=1)
        return torch.where(n > 0, axis.extreme(r, largest), 0.0)
    raise NotImplementedError(f"pooling {scheme!r} under node sharding")


def global_pool(x: torch.Tensor, mask: torch.Tensor, schemes,
                axis=None) -> torch.Tensor:
    """Concat of pooled features per scheme, ``[B, len(schemes)*D]``; a
    bare string means one scheme.  ``axis``: the ``graph`` axis of
    node-sharded events (:func:`sharded_pool`)."""
    if isinstance(schemes, str):
        schemes = (schemes,)
    if axis is not None:
        return torch.cat([sharded_pool(x, mask, s, axis) for s in schemes],
                         dim=-1)
    return torch.cat([POOLS[s](x, mask) for s in schemes], dim=-1)


def broadcast_to_nodes(g: torch.Tensor, L: int) -> torch.Tensor:
    """``[B, D] -> [B, L, D]`` (a view)."""
    return g[:, None, :].expand(g.shape[0], L, g.shape[1])


def homophily(
    idx: torch.Tensor, edge_mask: torch.Tensor, values: torch.Tensor,
    axis=None,
) -> torch.Tensor:
    """Fraction of valid edges whose endpoints share a value, per event.

    Args:
        idx: ``[B, L, k]`` neighbour indices.
        edge_mask: ``[B, L, k]`` valid-edge mask.
        values: ``[B, L]`` per-node scalar, or ``[B, L, C]``.

        axis: the ``graph`` axis of node-sharded events (``values``,
            ``idx`` this process's rows, ``idx`` global): the neighbours'
            values are all-gathered and the counts summed across it.

    Returns:
        ``[B]`` (scalar input) or ``[B, C]``.
    """
    single = values.dim() == 2
    if single:
        values = values[..., None]
    keys = values if axis is None else axis.gather_const(values)
    vj = gather_neighbors(keys, idx)  # [B, L, k, C]
    same = (values[:, :, None, :] == vj) & edge_mask[..., None]
    n_edges = edge_mask.sum(dim=(1, 2))
    n_same = same.sum(dim=(1, 2))
    if axis is not None:
        n_edges, n_same = axis.sum_const(n_edges), axis.sum_const(n_same)
    hom = n_same.to(values.dtype) / n_edges.clamp_min(1)[:, None]
    return hom[..., 0] if single else hom
