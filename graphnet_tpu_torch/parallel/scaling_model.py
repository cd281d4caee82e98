"""Weak-scaling model of training across cards (counterpart of
``graphnet_tpu/parallel/scaling_model.py``).

It combines

* the measured step time on one card (each card keeps its whole local
  batch under weak scaling, so its compute stays the same),
* the bytes a step's collectives move (:class:`CollectiveProfile`:
  the gradient all-reduce over the ``data`` axis and the node
  all-gathers over the ``graph`` axis), counted from the port's own
  collectives (``parallel/dryrun.py`` records them per layout), and
* the bandwidth of one link between two cards, ``link_gbps``,

into a predicted efficiency for a mesh:

``T_n = t_compute + exposed(all_reduce) + exposed(all_gather)``

* all-reduce (ring): ``2 (n-1)/n * bytes / link``; the backward pass
  makes gradients layer by layer, so the expected estimate exposes half
  of it and the conservative one all of it;
* all-gather: ``(n-1)/n * bytes / link`` a gather; the expected estimate
  exposes none of an asynchronous gather (``halo_async``), the
  conservative one all of it.

``efficiency = t_compute / T_n``.

There is no default link figure: ``link_gbps`` must come from a
measurement on a host with more than one card (NVLink and PCIe differ by
an order of magnitude), and a host with one card cannot give it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class CollectiveProfile:
    """The bytes one training step's collectives move."""

    grad_allreduce_bytes: float  # fp32 gradients over the data axis
    halo_allgather_bytes: float = 0.0  # node features over the graph axis
    halo_async: bool = True  # whether the gathers overlap compute


@dataclass
class ScalingPrediction:
    mesh_shape: tuple
    step_ms_single_chip: float
    t_allreduce_ms: float
    t_halo_ms: float
    efficiency_expected: float
    efficiency_conservative: float
    events_per_s_expected: float = 0.0
    detail: Dict[str, float] = field(default_factory=dict)


def _ring_allreduce_ms(bytes_: float, n: int, link_gbps: float) -> float:
    if n <= 1 or bytes_ <= 0:
        return 0.0
    return 2.0 * (n - 1) / n * bytes_ / (link_gbps * 1e9) * 1e3


def _allgather_ms(bytes_: float, n: int, link_gbps: float) -> float:
    if n <= 1 or bytes_ <= 0:
        return 0.0
    return (n - 1) / n * bytes_ / (link_gbps * 1e9) * 1e3


def predict_scaling(
    step_ms_single_chip: float,
    profile: CollectiveProfile,
    n_data: int,
    n_graph: int = 1,
    events_per_step: Optional[int] = None,
    *,
    link_gbps: float,
) -> ScalingPrediction:
    """The weak-scaling efficiency on an ``n_data x n_graph`` mesh.

    ``link_gbps`` (GB/s one way between two cards, keyword only) is
    required and has no default.  With ``events_per_step`` (a card's events a step)
    ``events_per_s_expected`` is the whole mesh's predicted rate.
    """
    if not link_gbps > 0:
        raise ValueError(
            "link_gbps must be the link bandwidth between two cards, "
            f"measured on a host with more than one card (got {link_gbps!r})")
    bw = float(link_gbps)
    t_ar = _ring_allreduce_ms(profile.grad_allreduce_bytes, n_data, bw)
    t_halo = _allgather_ms(profile.halo_allgather_bytes, n_graph, bw)
    exposed_expected = 0.5 * t_ar + (0.0 if profile.halo_async else t_halo)
    exposed_conservative = t_ar + t_halo
    t1 = step_ms_single_chip
    eff_e = t1 / (t1 + exposed_expected)
    eff_c = t1 / (t1 + exposed_conservative)
    n_chips = n_data * n_graph
    eps = 0.0
    if events_per_step:
        eps = events_per_step * n_chips / ((t1 + exposed_expected) / 1e3)
    return ScalingPrediction(
        mesh_shape=(n_data, n_graph),
        step_ms_single_chip=t1,
        t_allreduce_ms=t_ar,
        t_halo_ms=t_halo,
        efficiency_expected=eff_e,
        efficiency_conservative=eff_c,
        events_per_s_expected=eps,
        detail={
            "link_gbps": bw,
            "exposed_ms_expected": exposed_expected,
            "exposed_ms_conservative": exposed_conservative,
            "n_chips": float(n_chips),
        },
    )


def dynedge_headline_profile(param_count: int) -> CollectiveProfile:
    """The profile of data-parallel DynEdge training: the fp32 gradient
    of every parameter all-reduced once a step, no graph axis."""
    return CollectiveProfile(grad_allreduce_bytes=4.0 * param_count,
                             halo_allgather_bytes=0.0)
