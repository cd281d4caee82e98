"""Device meshes and the FSDP rule (counterpart of
``graphnet_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world,
one process a device, with the JAX package's axis names: ``("data",
"model")`` here, ``("data", "graph")`` in
:mod:`~graphnet_tpu_torch.parallel.graph_sharding`.  The rules below read
only axis sizes, so they also take a plain ``{axis: size}`` mapping (a
rule can then be held against the JAX one in a single process).

The FSDP rule is the JAX package's, to the letter, on the JAX layout of
each parameter (:mod:`graphnet_tpu_torch.utils.jax_params`: an
``nn.Linear`` weight is the transposed kernel): a parameter of at least
``min_size`` elements is sharded along its largest mesh-divisible
dimension (the first of equal ones), every other one stays replicated.
:func:`shard_fsdp` hands the rule to FSDP2 (``fully_shard``'s
``shard_placement_fn``); replicated parameters are FSDP2's
``ignored_params``, whose gradients the caller averages over the data
axis (the Trainer does).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Set, Union

import torch
from torch import nn

from graphnet_tpu_torch.batch import EventBatch

MeshLike = Union["torch.distributed.device_mesh.DeviceMesh", Mapping[str, int]]


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    device_type: str = "cuda",
):
    """2-D mesh ``(data, model)`` over the world's processes (one a
    device); ``n_data`` defaults to ``world // n_model``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, (
        f"mesh {n_data}x{n_model} != {world} processes"
    )
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def axis_size(mesh: MeshLike, axis: str) -> int:
    """Size of ``axis`` (1 where the mesh has no such axis)."""
    if isinstance(mesh, Mapping):
        return int(mesh.get(axis, 1))
    names = mesh.mesh_dim_names or ()
    return int(mesh.size(names.index(axis))) if axis in names else 1


def axis_index(mesh: MeshLike, axis: str) -> int:
    """This process's coordinate on ``axis`` (0 without such an axis)."""
    if isinstance(mesh, Mapping) or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return int(mesh.get_local_rank(axis))


def jax_dim(name: str, param: torch.Tensor, dim: int) -> int:
    """The JAX-layout dimension of ``param``'s ``dim`` (an ``nn.Linear``
    weight is the transposed kernel), and back: the map is its own
    inverse."""
    if name.split(".")[-1] == "weight" and param.dim() == 2:
        return 1 - dim
    return dim


def fsdp_sharding(
    mesh: MeshLike,
    params: Mapping[str, torch.Tensor],
    axis: str = "data",
    min_size: int = 2**14,
) -> Dict[str, Optional[int]]:
    """``{name: dim}`` of each parameter's shard dimension (the port's
    layout) over ``axis``, ``None`` for a replicated one; the JAX
    package's ``fsdp_sharding`` on the JAX layout."""
    n = axis_size(mesh, axis)
    specs: Dict[str, Optional[int]] = {}
    for name, p in params.items():
        specs[name] = None
        if p.dim() == 0 or p.numel() < min_size:
            continue
        shape = [p.shape[jax_dim(name, p, d)] for d in range(p.dim())]
        for d in sorted(range(p.dim()), key=lambda d: shape[d], reverse=True):
            if shape[d] % n == 0:
                specs[name] = jax_dim(name, p, d)
                break
    return specs


def shard_fsdp(
    model: nn.Module,
    mesh,
    axis: str = "data",
    min_size: int = 2**14,
    exclude: Set[nn.Parameter] = frozenset(),
) -> Set[nn.Parameter]:
    """Shard ``model`` in place with FSDP2 over ``axis`` by
    :func:`fsdp_sharding`'s placements; returns the parameters left
    replicated (below ``min_size``, no divisible dimension, or in
    ``exclude``), whose gradients FSDP2 does not reduce."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    named = dict(model.named_parameters())
    specs = fsdp_sharding(mesh, named, axis, min_size)
    ignored = {p for n, p in named.items()
               if specs[n] is None or p in exclude}
    dims = {id(p): specs[n] for n, p in named.items()}
    if len(ignored) < len(named):
        fully_shard(model, mesh=mesh[axis],
                    shard_placement_fn=lambda p: Shard(dims[id(p)]),
                    ignored_params=ignored)
    return ignored


def batch_rows(batch: EventBatch, start: int, size: int) -> EventBatch:
    """Events ``start .. start + size - 1`` of ``batch`` (views)."""
    B = batch.batch_size

    def rows(t):
        return t[start:start + size] if t.dim() >= 1 and t.shape[0] == B else t

    return batch.map(rows)


def shard_batch(batch: EventBatch, mesh: MeshLike, axis: str = "data"
                ) -> EventBatch:
    """This process's slice of a global batch over ``axis`` (every
    per-event and per-node tensor; the batch size must divide)."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    per = batch.batch_size // n
    assert per * n == batch.batch_size, (
        f"batch {batch.batch_size} not divisible by {axis}={n}")
    return batch_rows(batch, i * per, per)
