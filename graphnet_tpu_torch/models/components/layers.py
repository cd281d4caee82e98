"""Layers of the GNN backbones (counterpart of
``graphnet_tpu/models/components/layers.py``).

All layers work on the dense-padded ``[B, L, D]`` layout.  Attribute
names follow the flax module names of the JAX package (``self_dense``,
``nbr_dense``, ``out_kernel``, ``dense_0`` ...), so carrying weights
across is a matter of transposes (:mod:`graphnet_tpu_torch.utils.
jax_params`).

``dtype`` is the compute dtype of the matrix products (``None`` for
fp32 throughout, ``torch.bfloat16`` for the mixed-precision mode); the
parameters themselves stay fp32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from graphnet_tpu_torch.ops.edgeconv_cuda import fused_edgeconv
from graphnet_tpu_torch.ops.gather_reduce import edge_reduce, gather_neighbors
from graphnet_tpu_torch.ops.knn import knn_graph

Activation = Callable[[torch.Tensor], torch.Tensor]

ACTIVATIONS = {
    "relu": F.relu,
    "gelu": F.gelu,  # exact (erf) form, as the JAX package's gelu_exact
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "silu": F.silu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}

# activations the fused EdgeConv kernel computes, with their slopes
_KERNEL_SLOPES = {"relu": 0.0, "leaky_relu": 0.01}


def resolve_activation(act) -> Activation:
    if callable(act):
        return act
    return ACTIVATIONS[act.lower()]


def linear(
    layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]
) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (inputs and parameters cast to
    it, as flax's ``Dense(dtype=...)`` does), or as is for ``None``."""
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def lecun_normal_(
    w: torch.Tensor, fan_in: int, generator: torch.Generator
) -> None:
    """Normal(0, 1/fan_in) initialisation (flax's Dense default, untruncated)."""
    with torch.no_grad():
        w.copy_(
            torch.randn(w.shape, generator=generator) / math.sqrt(fan_in)
        )


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of ``module`` from ``generator``: dense
    weights LeCun-normal, biases zero, layer norms to identity."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, EdgeConv) and hasattr(m, "out_kernel"):
            lecun_normal_(m.out_kernel, m.out_kernel.shape[0], generator)
            nn.init.zeros_(m.out_bias)


def layer_norm(
    norm: nn.LayerNorm, x: torch.Tensor, dtype: Optional[torch.dtype]
) -> torch.Tensor:
    """LayerNorm with statistics in fp32 and the result in ``dtype``."""
    y = F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps
    )
    return y if dtype is None else y.to(dtype)


class MLP(nn.Module):
    """``[Linear, (LayerNorm), activation] * n``."""

    def __init__(
        self,
        in_features: int,
        sizes: Sequence[int],
        activation: str = "relu",
        add_norm_layer: bool = False,
        activate_final: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.sizes = tuple(sizes)
        self.act = resolve_activation(activation)
        self.add_norm_layer = add_norm_layer
        self.activate_final = activate_final
        self.dtype = dtype
        d = in_features
        for i, size in enumerate(self.sizes):
            setattr(self, f"dense_{i}", nn.Linear(d, size))
            if add_norm_layer:
                setattr(self, f"norm_{i}", nn.LayerNorm(size, eps=1e-5))
            d = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.sizes)):
            x = linear(getattr(self, f"dense_{i}"), x, self.dtype)
            if self.add_norm_layer:
                x = layer_norm(getattr(self, f"norm_{i}"), x, self.dtype)
            if self.activate_final or i + 1 < len(self.sizes):
                x = self.act(x)
        return x


class EdgeConv(nn.Module):
    """EdgeConv: message MLP over ``cat[x_i, x_j - x_i]``, masked
    aggregation over the ``[B, L, k]`` neighbour lists.

    The first linear layer is linearised, as in the JAX package:
    ``cat[x_i, x_j - x_i] @ [W1; W2] = x_i @ (W1 - W2) + x_j @ W2`` is a
    per-node self term (``self_dense``, with bias) plus a per-node
    neighbour term (``nbr_dense``, no bias).  A two-layer MLP without a
    norm layer owns its second layer as ``out_kernel [H1, H2]`` and
    ``out_bias``; with relu or leaky relu and add, max or mean
    aggregation it runs through :func:`fused_edgeconv` (the CUDA kernel
    for CUDA tensors, its plain version on the CPU).
    """

    def __init__(
        self,
        in_features: int,
        nn_sizes: Sequence[int],
        aggr: str = "max",
        activation: str = "relu",
        add_norm_layer: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.nn_sizes = tuple(nn_sizes)
        self.aggr = aggr
        self.activation = activation
        self.act = resolve_activation(activation)
        self.add_norm_layer = add_norm_layer
        self.dtype = dtype
        h0 = self.nn_sizes[0]
        self.self_dense = nn.Linear(in_features, h0)
        self.nbr_dense = nn.Linear(in_features, h0, bias=False)
        self.two_layer = len(self.nn_sizes) == 2 and not add_norm_layer
        if self.two_layer:
            h2 = self.nn_sizes[1]
            self.out_kernel = nn.Parameter(torch.empty(h0, h2))
            self.out_bias = nn.Parameter(torch.zeros(h2))
        else:
            if add_norm_layer:
                self.norm_0 = nn.LayerNorm(h0, eps=1e-5)
            if len(self.nn_sizes) > 1:
                self.nn = MLP(
                    h0,
                    self.nn_sizes[1:],
                    activation=activation,
                    add_norm_layer=add_norm_layer,
                    dtype=dtype,
                )

    @property
    def uses_kernel(self) -> bool:
        """Whether the forward goes through :func:`fused_edgeconv`."""
        return (
            self.two_layer
            and self.aggr in ("add", "max", "mean")
            and self.activation in _KERNEL_SLOPES
        )

    def forward(
        self,
        x: torch.Tensor,
        idx: torch.Tensor,
        edge_mask: torch.Tensor,
    ) -> torch.Tensor:
        a = linear(self.self_dense, x, self.dtype)  # x_i @ (W1 - W2) + bias
        b = linear(self.nbr_dense, x, self.dtype)  # x_j @ W2
        if self.two_layer:
            w2, b2 = self.out_kernel, self.out_bias
            if self.dtype is not None:
                w2, b2 = w2.to(self.dtype), b2.to(self.dtype)
            if self.uses_kernel:
                out = fused_edgeconv(
                    a, b, idx, edge_mask, w2, b2,
                    aggr="add" if self.aggr == "mean" else self.aggr,
                    slope=_KERNEL_SLOPES[self.activation],
                )
                if self.aggr == "mean":
                    n = edge_mask.sum(dim=2, keepdim=True).clamp_min(1)
                    out = out / n
                return out
            msgs = self.act(a[:, :, None, :] + gather_neighbors(b, idx))
            msgs = self.act(torch.matmul(msgs, w2) + b2)
            return edge_reduce(msgs.float(), edge_mask, self.aggr)

        msgs = a[:, :, None, :] + gather_neighbors(b, idx)
        if self.add_norm_layer:
            msgs = layer_norm(self.norm_0, msgs, self.dtype)
        msgs = self.act(msgs)
        if len(self.nn_sizes) > 1:
            msgs = self.nn(msgs)
        # reduce in fp32 regardless of compute dtype (sum accuracy)
        return edge_reduce(msgs.float(), edge_mask, self.aggr)


class DynEdgeConv(nn.Module):
    """EdgeConv followed by kNN recomputation on the new latents; returns
    ``(x, idx, edge_mask)`` with the adjacency for the next layer."""

    def __init__(
        self,
        in_features: int,
        nn_sizes: Sequence[int],
        aggr: str = "add",
        nb_neighbors: int = 8,
        features_subset: Tuple[int, ...] = (0, 1, 2),
        activation: str = "relu",
        add_norm_layer: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.nb_neighbors = nb_neighbors
        self.features_subset = list(features_subset)
        self.conv = EdgeConv(
            in_features,
            nn_sizes,
            aggr=aggr,
            activation=activation,
            add_norm_layer=add_norm_layer,
            dtype=dtype,
        )

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor,
        idx: torch.Tensor,
        edge_mask: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.conv(x, idx, edge_mask)
        new_idx, new_edge_mask = knn_graph(
            x[..., self.features_subset], mask, k=self.nb_neighbors
        )
        return x, new_idx, new_edge_mask
