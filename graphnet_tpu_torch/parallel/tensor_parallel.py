"""Megatron tensor parallelism for the transformer layers (counterpart of
``graphnet_tpu/parallel/tensor_parallel.py``).

The JAX package's rule, over the same module names (the port keeps the
flax names): column-parallel layers (``_COL``: attention input
projections, first feed-forward layers) shard their output features
over ``model``, row-parallel ones (``_ROW``: out projections, second
feed-forward layers) their input features; the row layers' biases stay
replicated, added after the all-reduce.  A dimension that does not
divide warns and stays replicated, as there.

The JAX package expresses this as parameter shardings and lets GSPMD
insert the one all-reduce a block.  The port holds Megatron-style local
shards instead: :func:`shard_tensor_parallel` replaces each matched
parameter of a :class:`~graphnet_tpu_torch.models.components.layers.
MultiHeadAttention` (``qkv``, ``out``) and ``TransformerEncoderLayer``
(``linear1``, ``linear2``) by this process's plain-tensor shard and
gives the layer a :class:`TPGroup`.  The layer then runs on its local
heads: the flash kernels (rows 5a-c), ``ctypes`` operators with no
DTensor sharding rule, take the local ``[B, H / n, L, Dh]`` tensors as
they are.  A column layer's input passes :func:`copy_to_tp` (identity
forward, all-reduce of the gradient backward), a row layer's partial
output :func:`reduce_from_tp` (all-reduce forward, identity backward):
one all-reduce a block each way, as Megatron-LM.  ``qkv``'s shard is
head-aligned (this process's heads of each of q, k, v): the JAX spec
shards that output dimension in contiguous blocks and GSPMD reshards to
heads; the leaves and dimensions sharded are the same.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from graphnet_tpu_torch.parallel.mesh import MeshLike, axis_index, axis_size, jax_dim

# Column-parallel layers (output-feature sharding) and row-parallel ones
# (input-feature sharding): the JAX package's names
_COL = ("qkv", "proj_q", "proj_k", "proj_v", "fc1", "linear1")
_ROW = ("out", "proj", "fc2", "linear2")


def _jax_path(name: str, p: torch.Tensor) -> Tuple[str, str]:
    """``(module, leaf)`` of ``name`` in the JAX tree (``weight`` of a
    2-D parameter is ``kernel``, of a 1-D one ``scale``)."""
    *path, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if p.dim() == 2 else "scale"
    return (path[-1] if path else ""), leaf


def tensor_parallel_sharding(
    mesh: MeshLike, params: Mapping[str, torch.Tensor], axis: str = "model"
) -> Dict[str, Optional[int]]:
    """``{name: dim}`` of each parameter's shard dimension over ``axis``
    (the port's layout), ``None`` for a replicated one: the JAX
    package's ``tensor_parallel_sharding``."""
    n = axis_size(mesh, axis)
    specs: Dict[str, Optional[int]] = {}
    for name, p in params.items():
        specs[name] = None
        if p.dim() == 0:
            continue
        mod, leaf = _jax_path(name, p)
        if mod in _COL:
            d = p.dim() - 1  # kernel [in, out]: out; bias [out]
            if p.shape[jax_dim(name, p, d)] % n:
                warnings.warn(f"TP: {mod}/{leaf} dim "
                              f"{p.shape[jax_dim(name, p, d)]} not divisible "
                              f"by model={n}; replicating")
                continue
            specs[name] = jax_dim(name, p, d)
        elif mod in _ROW and leaf == "kernel" and p.dim() >= 2:
            if p.shape[jax_dim(name, p, 0)] % n:
                warnings.warn(f"TP: {mod}/kernel dim "
                              f"{p.shape[jax_dim(name, p, 0)]} not divisible "
                              f"by model={n}; replicating")
                continue
            specs[name] = jax_dim(name, p, 0)
    return specs


def count_tp_sharded(params: Mapping[str, torch.Tensor], mesh: MeshLike,
                     axis: str = "model") -> int:
    """Number of parameters the rule shards over ``axis`` (a TP run where
    nothing shards is a silent no-op)."""
    specs = tensor_parallel_sharding(mesh, params, axis)
    return sum(d is not None for d in specs.values())


@dataclass(frozen=True)
class TPGroup:
    """The ``model`` axis as a layer sees it: group, size, position."""

    group: object
    n: int
    i: int


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.tp.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=tp.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """A column layer's input: identity, all-reduce of the gradient."""
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """A row layer's partial output: all-reduce, identity backward."""
    return _ReduceFromTP.apply(x, tp)


def _rows_of_heads(out_features: int, parts: int, tp: TPGroup) -> torch.Tensor:
    """Indices of this process's rows of a weight whose ``out_features``
    are ``parts`` equal blocks (q, k, v) each split over ``tp.n``."""
    block = out_features // parts
    per = block // tp.n
    return torch.cat([torch.arange(b * block + tp.i * per,
                                   b * block + (tp.i + 1) * per)
                      for b in range(parts)])


def _keep(module: nn.Module, name: str, dim: int, index: torch.Tensor) -> None:
    p = getattr(module, name)
    shard = p.detach().index_select(dim, index.to(p.device)).clone()
    setattr(module, name, nn.Parameter(shard, requires_grad=p.requires_grad))


def shard_tensor_parallel(model: nn.Module, mesh, axis: str = "model") -> int:
    """Replace the matched layers' parameters of ``model`` in place by
    this process's shards and switch those layers to their local path;
    returns the number of parameters sharded.  Raises where a layer the
    rule matches has no local path, or where its heads or features do
    not divide over ``axis``."""
    from graphnet_tpu_torch.models.components.layers import (
        MultiHeadAttention,
        TransformerEncoderLayer,
    )

    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    tp = TPGroup(mesh.get_group(axis), n, i)
    named = dict(model.named_parameters())
    specs = tensor_parallel_sharding(mesh, named, axis)
    owners = {}
    for mname, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):
            owners[f"{mname}.qkv"] = m
            owners[f"{mname}.out"] = m
        elif isinstance(m, TransformerEncoderLayer):
            owners[f"{mname}.linear1"] = m
            owners[f"{mname}.linear2"] = m
    sharded = [name for name, d in specs.items() if d is not None]
    for name in sharded:
        layer = name.rsplit(".", 1)[0]
        if layer not in owners:
            raise NotImplementedError(
                f"TP: {name} matches the rule but its layer has no local "
                "path in the port")
    for layer, owner in owners.items():
        lin = dict(model.named_modules())[layer]
        w = f"{layer}.weight"
        if specs.get(w) is None:
            raise ValueError(f"TP: {w} does not divide over {axis}={n}")
        col = layer.endswith(("qkv", "linear1"))
        if col:
            parts = 3 if layer.endswith("qkv") else 1
            if layer.endswith("qkv") and owner.num_heads % n:
                raise ValueError(f"TP: {owner.num_heads} heads do not divide "
                                 f"over {axis}={n}")
            index = _rows_of_heads(lin.out_features, parts, tp)
            _keep(lin, "weight", 0, index)
            _keep(lin, "bias", 0, index)
        else:
            per = lin.in_features // n
            _keep(lin, "weight", 1, torch.arange(i * per, (i + 1) * per))
        owner.tp = tp
    return len(sharded)


def tp_params(model: nn.Module):
    """The parameters :func:`shard_tensor_parallel` sharded (each process
    holds its own part)."""
    out = []
    for m in model.modules():
        tp = getattr(m, "tp", None)
        if tp is None:
            continue
        for lin, col in _tp_linears(m):
            out.append(lin.weight)
            if col:
                out.append(lin.bias)
    return out


def _tp_linears(m):
    from graphnet_tpu_torch.models.components.layers import MultiHeadAttention

    if isinstance(m, MultiHeadAttention):
        return [(m.qkv, True), (m.out, False)]
    return [(m.linear1, True), (m.linear2, False)]


def full_tp_state(model: nn.Module, state: Optional[Mapping] = None
                  ) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` (or ``state``, tensors named and shaped
    as it) with every TP shard all-gathered back to the whole parameter
    (collective over the model axis)."""
    state = dict(model.state_dict() if state is None else state)
    for mname, m in model.named_modules():
        tp = getattr(m, "tp", None)
        if tp is None:
            continue
        for lname, (lin, col) in zip(_linear_names(m), _tp_linears(m)):
            prefix = f"{mname}.{lname}" if mname else lname
            for leaf in (("weight", "bias") if col else ("weight",)):
                t = state[f"{prefix}.{leaf}"].detach().contiguous()
                parts = [torch.empty_like(t) for _ in range(tp.n)]
                dist.all_gather(parts, t, group=tp.group)
                dim = 0 if col else 1
                if col and lname == "qkv":  # head-aligned: q, k, v blocks
                    full = torch.cat([torch.cat([p.chunk(3, 0)[b] for p in parts])
                                      for b in range(3)])
                else:
                    full = torch.cat(parts, dim=dim)
                state[f"{prefix}.{leaf}"] = full
    return state


def _linear_names(m):
    from graphnet_tpu_torch.models.components.layers import MultiHeadAttention

    return ("qkv", "out") if isinstance(m, MultiHeadAttention) else (
        "linear1", "linear2")


def local_tp_state(model: nn.Module, full: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """This process's shards of a whole ``state_dict`` (the inverse of
    :func:`full_tp_state`)."""
    state = dict(full)
    for mname, m in model.named_modules():
        tp = getattr(m, "tp", None)
        if tp is None:
            continue
        for lname, (lin, col) in zip(_linear_names(m), _tp_linears(m)):
            prefix = f"{mname}.{lname}" if mname else lname
            w = state[f"{prefix}.weight"]
            if col:
                index = _rows_of_heads(w.shape[0], 3 if lname == "qkv" else 1,
                                       tp).to(w.device)
                state[f"{prefix}.weight"] = w.index_select(0, index)
                state[f"{prefix}.bias"] = state[f"{prefix}.bias"].index_select(
                    0, index)
            else:
                per = w.shape[1] // tp.n
                state[f"{prefix}.weight"] = w[:, tp.i * per:(tp.i + 1) * per]
    return state
