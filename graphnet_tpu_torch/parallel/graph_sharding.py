"""Node-axis sharding of one padded batch (counterpart of
``graphnet_tpu/parallel/graph_sharding.py``).

Events of 10k+ pulses (the TITO / Gen2 configurations) can outgrow one
device; here the padded node axis L is split over a ``graph`` mesh axis,
each process holding ``L / n_graph`` rows of every event of its data
slice.  The JAX package annotates shardings and lets GSPMD insert the
collectives; the port writes them out, and the kernels stay on the path:

  * kNN: the coordinates (3 or 4 columns) are all-gathered and row 1
    builds the whole event's graph, of which each process keeps its own
    query rows with global key indices (the same neighbours as the
    unsharded event, bit for bit);
  * EdgeConv: the conv input is all-gathered once a layer (in the compute
    dtype); the neighbour term is formed for every node, the self term
    for the local rows.  Row 2 runs on the whole event with the other
    processes' rows as padding nodes (no valid edge), whose blocks write
    zeros and return, so the edge work stays local; row 3 likewise, and
    its ``db`` returns through the all-gather's backward, a
    reduce-scatter;
  * pooling and every other reduction over nodes (sum, mean with its
    counts, max, min) reduces across the ``graph`` axis.

The collectives are adjoint pairs (all-gather / reduce-scatter, all-reduce
/ all-reduce), so each process's backward gives the gradient of the sum
of the processes' losses; every process of a graph group computes the
same loss, and the Trainer averages parameter gradients over the whole
mesh, which is the JAX package's rule (summed over ``graph``, averaged
over ``data``) for a loss taken once per graph group.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.parallel.mesh import axis_index, axis_size, shard_batch


def make_dp_graph_mesh(n_data: int, n_graph: int, device_type: str = "cuda"):
    """2-D mesh ``(data, graph)`` over the world: DP over events times
    node sharding within events."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    assert n_data * n_graph == world, (n_data, n_graph, world)
    return init_device_mesh(device_type, (n_data, n_graph),
                            mesh_dim_names=("data", "graph"))


@dataclass(frozen=True)
class GraphAxis:
    """The ``graph`` axis as the model code sees it: its process group,
    its size ``n`` and this process's position ``i`` (rows ``i * Ls ..
    (i + 1) * Ls - 1`` of each event)."""

    group: object
    n: int
    i: int

    # -- node axis
    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, Ls, ...] -> [B, L, ...]``, differentiable (its backward
        is the reduce-scatter of the gradient)."""
        return _GatherNodes.apply(x, self)

    def gather_const(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`gather` without a gradient (coordinates, masks)."""
        with torch.no_grad():
            return _gather_nodes(x.detach(), self)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a whole-event ``[B, L, ...]``."""
        Ls = x.shape[1] // self.n
        return x[:, self.i * Ls:(self.i + 1) * Ls]

    def pad_rows(self, x: torch.Tensor, n_rows: int) -> torch.Tensor:
        """``[B, Ls, ...]`` placed at this process's rows of zeros
        ``[B, n_rows, ...]`` (False for bool), differentiable."""
        Ls = x.shape[1]
        before = self.i * Ls
        after = n_rows - before - Ls
        if x.dtype == torch.bool:
            out = x.new_zeros((x.shape[0], n_rows) + x.shape[2:])
            out[:, before:before + Ls] = x
            return out
        pad = [0, 0] * (x.dim() - 2) + [before, after]
        return torch.nn.functional.pad(x, pad)

    # -- reductions over the nodes of an event
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce sum, differentiable (backward: all-reduce sum)."""
        return _AllReduceSum.apply(x, self)

    def sum_const(self, x: torch.Tensor) -> torch.Tensor:
        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def extreme(self, x: torch.Tensor, largest: bool) -> torch.Tensor:
        """Max (``largest``) or min over the processes, differentiable:
        the gradient goes to the processes holding the extreme, split
        equally at a tie across them."""
        best = x.detach().clone()
        dist.all_reduce(best, op=dist.ReduceOp.MAX if largest
                        else dist.ReduceOp.MIN, group=self.group)
        hit = x.detach() == best
        count = self.sum_const(hit.to(x.dtype))
        return self.sum(torch.where(hit, x, 0.0)) / count


def _gather_nodes(x: torch.Tensor, axis: GraphAxis) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.n)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=1)


class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather_nodes(x, axis)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        parts = [p.contiguous() for p in g.chunk(axis.n, dim=1)]
        out = torch.empty_like(parts[axis.i])
        dist.reduce_scatter(out, parts, group=axis.group)
        return out, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        out = x.contiguous().clone()
        dist.all_reduce(out, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


_AXIS: contextvars.ContextVar[Optional[GraphAxis]] = contextvars.ContextVar(
    "graphnet_torch_graph_axis", default=None)


@contextlib.contextmanager
def graph_sharding_hints(mesh) -> Iterator[None]:
    """Make ``mesh``'s ``graph`` axis visible to model code inside the
    block (:func:`current_graph_axis`).  Only a mesh with a ``graph``
    axis of more than one process changes behaviour: the model layers
    then take the node-sharded path above."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if mesh is None or "graph" not in names or axis_size(mesh, "graph") < 2:
        yield
        return
    axis = GraphAxis(mesh.get_group("graph"), axis_size(mesh, "graph"),
                     axis_index(mesh, "graph"))
    token = _AXIS.set(axis)
    try:
        yield
    finally:
        _AXIS.reset(token)


def current_graph_axis() -> Optional[GraphAxis]:
    """The ``graph`` axis set by :func:`graph_sharding_hints`, or None
    (the JAX package's ``current_graph_mesh``: the model code needs only
    the axis)."""
    return _AXIS.get()


def shard_batch_nodes(batch: EventBatch, mesh, data_axis: str = "data"
                      ) -> EventBatch:
    """This process's part of a global batch: its events over
    ``data_axis`` and its rows of the node axis over ``graph`` (``x``,
    ``mask`` and node labels; per-event labels, ``n_pulses`` and event
    weights stay whole; a batch with given edges is refused).  ``L``
    must divide by the graph size."""
    return node_rows(shard_batch(batch, mesh, data_axis), mesh)


def node_rows(batch: EventBatch, mesh) -> EventBatch:
    """This process's rows of the node axis (see :func:`shard_batch_nodes`)."""
    n, i = axis_size(mesh, "graph"), axis_index(mesh, "graph")
    L = batch.max_length
    Ls = L // n
    assert Ls * n == L, f"L={L} not divisible by graph={n}"

    def rows(t):
        return None if t is None else t[:, i * Ls:(i + 1) * Ls]

    if batch.edges is not None:
        raise ValueError("a batch with given edges cannot be node-sharded: "
                         "its neighbour lists would index other rows")
    return EventBatch(
        x=rows(batch.x), mask=rows(batch.mask), n_pulses=batch.n_pulses,
        labels=dict(batch.labels),
        node_labels={k: rows(v) for k, v in batch.node_labels.items()},
        event_weight=batch.event_weight)
