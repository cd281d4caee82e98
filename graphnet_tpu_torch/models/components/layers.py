"""Layers of the GNN backbones (counterpart of
``graphnet_tpu/models/components/layers.py``).

All layers work on the dense-padded ``[B, L, D]`` layout.  Attribute
names follow the flax module names of the JAX package (``self_dense``,
``nbr_dense``, ``out_kernel``, ``dense_0``, ``qkv``, ``norm1`` ...), so
carrying weights across is a matter of transposes
(:mod:`graphnet_tpu_torch.utils.jax_params`).

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
from torch.utils.checkpoint import checkpoint

from graphnet_tpu_torch.ops.edgeconv_cuda import (
    KNN_DIMS,
    KNN_MAX_K,
    KNN_MAX_L,
    fused_edgeconv,
    fused_edgeconv_knn,
)
from graphnet_tpu_torch.ops.flash_attention_cuda import (
    _scaled_q,
    flash_attention,
    supported as flash_supported,
)
from graphnet_tpu_torch.ops.gather_reduce import edge_reduce, gather_neighbors
from graphnet_tpu_torch.ops.gelu import gelu_exact
from graphnet_tpu_torch.ops.knn import coordinate_view, knn_graph
from graphnet_tpu_torch.ops.rel_flash_attention import (
    supported as rel_supported,
)
from graphnet_tpu_torch.ops.rel_flash_attention_cuda import rel_flash_attention
from graphnet_tpu_torch.models.components import stochastic
from graphnet_tpu_torch.models.components.stochastic import Dropout
from graphnet_tpu_torch.parallel import tensor_parallel
from graphnet_tpu_torch.parallel.graph_sharding import current_graph_axis

# opt-in switch for the fused EdgeConv + kNN kernel (the JAX package's
# default, off): where it holds (EdgeConv.uses_fused_knn) each DynEdge
# conv computes the next layer's adjacency in its own kernel.  Read at
# call time, so setting it on the module turns it on for every model.
FUSE_CONV_KNN = False

Activation = Callable[[torch.Tensor], torch.Tensor]

ACTIVATIONS = {
    "relu": F.relu,
    "gelu": gelu_exact,
    # slope 1 at exactly 0, as jax.nn.leaky_relu (torch's takes 0.01
    # there): an event with one pulse feeds exact zeros to TITO's MLPs
    "leaky_relu": lambda x: torch.where(x >= 0, x, 0.01 * x),
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


def row_parallel(layer: nn.Linear, x: torch.Tensor,
                 dtype: Optional[torch.dtype], tp) -> torch.Tensor:
    """A row-parallel ``layer(x)``: this process's input features times
    its weight shard, all-reduced over the model axis, then the
    (replicated) bias, in ``dtype`` as :func:`linear`."""
    w = layer.weight if dtype is None else layer.weight.to(dtype)
    y = tensor_parallel.reduce_from_tp(
        torch.matmul(x if dtype is None else x.to(dtype), w.t()), tp)
    return y + (layer.bias if dtype is None else layer.bias.to(dtype))


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
    weights LeCun-normal, biases zero, layer norms to identity; a module
    with parameters of its own kind (a lookup table, a cls token)
    initialises them in its ``init_parameters(generator)``."""
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
        elif hasattr(m, "init_parameters"):
            m.init_parameters(generator)


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
    neighbour term (``nbr_dense``, no bias).  TITO's message
    ``cat[x_i, x_j - x_i, x_j]`` folds into the same pair (``tito=True``
    changes no arithmetic, as in the JAX package).  A two-layer MLP without a
    norm layer owns its second layer as ``out_kernel [H1, H2]`` and
    ``out_bias``; with relu or leaky relu and add, max or mean
    aggregation it runs through :func:`fused_edgeconv` (the CUDA kernel
    for CUDA tensors, its plain version on the CPU).

    ``knn_k`` and ``knn_subset`` ``(lo, hi)``: where
    :meth:`uses_fused_knn` holds, the forward (given the node ``mask``)
    also returns the next layer's kNN over ``out[..., lo:hi]``, computed
    by :func:`fused_edgeconv_knn` in the conv's own kernel, as the tuple
    ``(out, idx, edge_mask)``.
    """

    def __init__(
        self,
        in_features: int,
        nn_sizes: Sequence[int],
        aggr: str = "max",
        activation: str = "relu",
        add_norm_layer: bool = False,
        tito: bool = False,
        dtype: Optional[torch.dtype] = None,
        knn_k: int = 0,
        knn_subset: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        self.tito = tito
        self.knn_k = knn_k
        self.knn_subset = knn_subset
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

    def uses_fused_knn(self, L: int, mask: Optional[torch.Tensor]) -> bool:
        """Whether the forward returns the next layer's kNN from the fused
        kernel: the JAX package's gate (``EdgeConv._use_fused_knn``),
        with the kernel route and the kernel's limits (k, columns) in
        place of its TPU test.  ``mean`` divides after the kernel, which
        would change the coordinates the kNN sees, so it is out."""
        return (
            FUSE_CONV_KNN
            and current_graph_axis() is None
            and 0 < self.knn_k <= KNN_MAX_K
            and self.knn_subset is not None
            and self.knn_subset[1] - self.knn_subset[0] in KNN_DIMS
            and mask is not None
            and self.aggr in ("add", "max")
            and L <= KNN_MAX_L
            and self.uses_kernel
        )

    def linear_terms(self, x: torch.Tensor, axis=None):
        """The linearised first layer's two per-node terms ``(a, b)``: an
        edge's pre-activation is ``a_i + b_j``.  Under node sharding
        (``axis``, ``parallel/graph_sharding.py``) ``x`` is this process's
        rows: the input is all-gathered once, in the compute dtype, so
        ``a`` covers the local rows and ``b`` every node of the event."""
        a = linear(self.self_dense, x, self.dtype)  # x_i @ (W1 - W2) + bias
        if axis is not None:
            x = axis.gather(x if self.dtype is None else x.to(self.dtype))
        b = linear(self.nbr_dense, x, self.dtype)  # x_j @ W2
        return a, b

    def forward(
        self,
        x: torch.Tensor,
        idx: torch.Tensor,
        edge_mask: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
    ):
        axis = current_graph_axis()
        a, b = self.linear_terms(x, axis)
        if self.two_layer:
            w2, b2 = self.out_kernel, self.out_bias
            if self.dtype is not None:
                w2, b2 = w2.to(self.dtype), b2.to(self.dtype)
            if self.uses_fused_knn(x.shape[1], mask):
                lo, hi = self.knn_subset
                return fused_edgeconv_knn(
                    a, b, idx, edge_mask, mask, w2, b2, aggr=self.aggr,
                    slope=_KERNEL_SLOPES[self.activation], knn_k=self.knn_k,
                    sub_lo=lo, sub_hi=hi,
                )
            if self.uses_kernel:
                kernel = dict(aggr="add" if self.aggr == "mean" else self.aggr,
                              slope=_KERNEL_SLOPES[self.activation])
                if axis is None:
                    out = fused_edgeconv(a, b, idx, edge_mask, w2, b2, **kernel)
                else:
                    # the whole event, the other processes' rows padding
                    # nodes (no valid edge), whose blocks exit at once
                    L = b.shape[1]
                    out = axis.local_rows(fused_edgeconv(
                        axis.pad_rows(a, L), b, axis.pad_rows(idx, L),
                        axis.pad_rows(edge_mask, L), w2, b2, **kernel))
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
    ``(x, idx, edge_mask)`` with the adjacency for the next layer.  A
    contiguous ``features_subset`` lets the conv compute that adjacency
    in its own kernel where :data:`FUSE_CONV_KNN` is on."""

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
        fs = tuple(features_subset)
        contiguous = fs == tuple(range(fs[0], fs[0] + len(fs)))
        self.conv = EdgeConv(
            in_features,
            nn_sizes,
            aggr=aggr,
            activation=activation,
            add_norm_layer=add_norm_layer,
            dtype=dtype,
            knn_k=nb_neighbors if contiguous else 0,
            knn_subset=(fs[0], fs[0] + len(fs)) if contiguous else None,
        )

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor,
        idx: torch.Tensor,
        edge_mask: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        res = self.conv(x, idx, edge_mask, mask=mask)
        if isinstance(res, tuple):
            return res
        x = res
        new_idx, new_edge_mask = sharded_knn_graph(
            coordinate_view(x, self.features_subset), mask,
            k=self.nb_neighbors,
        )
        return x, new_idx, new_edge_mask


def sharded_knn_graph(
    coords: torch.Tensor, mask: torch.Tensor, k: int, knn=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``knn`` (this module's :func:`knn_graph` by default), also under
    node sharding (``parallel/graph_sharding.py``): the coordinates and
    the mask are all-gathered, row 1 builds the whole event's graph, and
    this process keeps its query rows (global key indices), the
    unsharded event's neighbours bit for bit."""
    knn = knn_graph if knn is None else knn
    axis = current_graph_axis()
    if axis is None:
        return knn(coords, mask, k=k)
    idx, edge_mask = knn(axis.gather_const(coords), axis.gather_const(mask),
                         k=k)
    return axis.local_rows(idx), axis.local_rows(edge_mask)


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    dropout: Optional[Dropout] = None,
) -> torch.Tensor:
    """The JAX package's dense masked softmax attention over ``[B, H, L,
    Dh]``: fp32 logits scaled after the product, padded keys at the
    float32 minimum, the softmax in fp32 (then ``dropout`` of the
    probabilities, where given) and the value product in v's dtype.
    Returns ``[B, H, L, Dh]`` in v's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits / math.sqrt(q.shape[-1])
    if attn_bias is not None:
        logits = logits + attn_bias
    if key_padding_mask is not None:
        logits = torch.where(
            key_padding_mask[:, None, None, :], logits,
            torch.finfo(logits.dtype).min,
        )
    attn = torch.softmax(logits, dim=-1)
    if dropout is not None:
        attn = dropout(attn)
    return torch.matmul(attn.to(v.dtype), v)


class MultiHeadAttention(nn.Module):
    """Masked multi-head self-attention (the JAX package's stand-in for
    torch's ``nn.MultiheadAttention``): one ``qkv`` projection of width
    ``3 D`` split as ``[q | k | v]`` with the heads contiguous within
    each third, scaled dot-product attention with a key-padding mask,
    and the ``out`` projection.

    Without a bias, with a head dim the kernels take and with the
    attention-probability dropout off, attention runs through
    :func:`flash_attention` (the CUDA kernels for CUDA tensors, their
    plain versions on the CPU) at every length; otherwise through
    :func:`dense_attention`.  The dropout (``dropout_rate``, on with
    ``deterministic=False`` in training mode) drops softmax
    probabilities, which the flash kernels do not form, so it takes the
    dense path, as in the JAX package.
    """

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        dropout_rate: float = 0.0,
        deterministic: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed dim {embed_dim} not divisible by heads {num_heads}"
            )
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)
        self.attn_dropout = Dropout(dropout_rate, deterministic)
        # the model axis once parallel.tensor_parallel shards qkv and out
        self.tp = None

    def uses_flash(self, attn_bias: Optional[torch.Tensor] = None) -> bool:
        head_dim = self.out.out_features // self.num_heads
        return (attn_bias is None and not self.attn_dropout.active
                and flash_supported(head_dim))

    def forward(
        self,
        x: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
        attn_bias: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H
        if self.tp is not None:
            # this process's heads (parallel/tensor_parallel.py)
            H, D = H // self.tp.n, D // self.tp.n
            x = tensor_parallel.copy_to_tp(x, self.tp)
        q, k, v = linear(self.qkv, x, self.dtype).split(D, dim=-1)

        def heads(t):
            return t.reshape(B, L, H, hd).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        if self.tp is not None and self.attn_dropout.active:
            raise NotImplementedError(
                "attention dropout in a tensor-parallel attention layer")
        if self.uses_flash(attn_bias):
            out = flash_attention(q, k, v, key_padding_mask)
        else:
            out = dense_attention(q, k, v, key_padding_mask, attn_bias,
                                  self.attn_dropout)
        out = out.transpose(1, 2).reshape(B, L, D)
        if self.tp is not None:
            return row_parallel(self.out, out, self.dtype, self.tp)
        return linear(self.out, out, self.dtype)


class TransformerEncoderLayer(nn.Module):
    """torch-style post-norm encoder layer, as DynTrans uses it:
    ``x = norm1(x + drop(MHA(x))); x = norm2(x + drop(FFN(x)))`` with a
    ReLU feed-forward of width ``dim_feedforward`` whose hidden layer is
    dropped too.  ``dropout_rate`` (on with ``deterministic=False`` in
    training mode) is torch's: the attention probabilities, both
    residual branches and the feed-forward's hidden layer, drawn in that
    order.  The layer norms run in fp32; the dense layers in ``dtype``."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        dim_feedforward: int = 2048,
        dropout_rate: float = 0.0,
        deterministic: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.mha = MultiHeadAttention(embed_dim, num_heads,
                                      dropout_rate=dropout_rate,
                                      deterministic=deterministic, dtype=dtype)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.activation = nn.ReLU()
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.drop = Dropout(dropout_rate, deterministic)
        # the model axis once parallel.tensor_parallel shards the FFN
        self.tp = None

    def forward(
        self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        h = self.drop(self.mha(x, key_padding_mask))
        x = layer_norm(self.norm1, x + h, None)
        if self.tp is not None:
            if self.drop.active:
                raise NotImplementedError(
                    "dropout inside a tensor-parallel feed-forward layer")
            h = linear(self.linear1, tensor_parallel.copy_to_tp(x, self.tp),
                       self.dtype)
            h = row_parallel(self.linear2, self.activation(h), self.dtype,
                             self.tp)
        else:
            h = self.drop(self.activation(linear(self.linear1, x, self.dtype)))
            h = self.drop(linear(self.linear2, h, self.dtype))
        return layer_norm(self.norm2, x + h, None)


class DynTrans(nn.Module):
    """TITO block: EdgeConv (TITO message, leaky relu, plus a residual
    when the widths match), LayerNorm, then one transformer encoder
    layer over the event with the node mask as key-padding mask.  The
    kNN graph is not recomputed.  ``dropout_rate`` and ``deterministic``
    go to the encoder layer.  Returns fp32."""

    def __init__(
        self,
        layer_sizes: Sequence[int] = (256, 256, 256),
        aggr: str = "max",
        n_head: int = 8,
        dropout_rate: float = 0.0,
        deterministic: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        in_features, *sizes = layer_sizes
        self.residual = sizes[-1] == in_features
        self.conv = EdgeConv(
            in_features, sizes, aggr=aggr, activation="leaky_relu",
            tito=True, dtype=dtype,
        )
        self.norm1 = nn.LayerNorm(sizes[-1], eps=1e-5)
        self.transformer = TransformerEncoderLayer(
            sizes[-1], n_head, dropout_rate=dropout_rate,
            deterministic=deterministic, dtype=dtype,
        )

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor,
        idx: torch.Tensor,
        edge_mask: torch.Tensor,
    ) -> torch.Tensor:
        x_out = self.conv(x, idx, edge_mask)
        x = x + x_out if self.residual else x_out
        x = layer_norm(self.norm1, x, None)
        return self.transformer(x, key_padding_mask=mask).float()


# ------------------------------------------------------- DeepIce blocks
class DropPath(nn.Module):
    """Stochastic depth: on (``drop_prob > 0``, ``deterministic=False``,
    training mode) it keeps each sample's branch with probability ``1 -
    drop_prob``, one Bernoulli a sample, as ``where(mask, x / keep, 0)``;
    the identity otherwise.  :meth:`draw` draws the ``[B, 1, ..., 1]``
    mask ahead, for a caller that recomputes the branch (DeepIce's
    ``remat``) and must see the same mask twice."""

    def __init__(self, drop_prob: float = 0.0, deterministic: bool = True):
        super().__init__()
        self.drop_prob = float(drop_prob)
        self.deterministic = deterministic

    @property
    def active(self) -> bool:
        return (self.drop_prob > 0.0 and not self.deterministic
                and self.training)

    def draw(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The keep mask for a branch shaped like ``x``, or ``None``
        when the layer is off."""
        if not self.active:
            return None
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return stochastic.keep_mask(shape, 1.0 - self.drop_prob, x.device)

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if mask is None:
            mask = self.draw(x)
        if mask is None:
            return x
        return stochastic.apply_keep(x, 1.0 - self.drop_prob, lambda: mask)


class Mlp(nn.Module):
    """Two dense layers with an exact GELU between them (``fc1``,
    ``fc2``), in ``dtype``; ``dropout`` after each (on with
    ``deterministic=False`` in training mode)."""

    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        dropout: float = 0.0,
        deterministic: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)
        self.drop = Dropout(dropout, deterministic)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(gelu_exact(linear(self.fc1, x, self.dtype)))
        return self.drop(linear(self.fc2, x, self.dtype))


def _dense_rel_attention(q, k, v, key_padding_mask, rel):
    """The JAX package's materialised ``AttentionRel`` path over ``[B, H,
    L, hd]`` with q already scaled: fp32 logits ``q.k (+ q.rel_ij)``,
    padded keys at the float32 minimum, the softmax in fp32, the
    weights in v's dtype for ``a.v``, and ``a.rel`` added in fp32 and
    rounded to v's dtype.  Returns ``[B, L, H, hd]`` in v's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if rel is not None:
        logits = logits + torch.einsum("bhic,bijc->bhij", q.float(), rel.float())
    if key_padding_mask is not None:
        logits = torch.where(key_padding_mask[:, None, None, :], logits,
                             torch.finfo(torch.float32).min)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(attn, v).transpose(1, 2)
    if rel is not None:
        out = out + torch.einsum(
            "bhij,bijc->bihc", attn.float(), rel.float()).to(out.dtype)
    return out


class AttentionRel(nn.Module):
    """BEiTv2-style attention with DeepIce's relative spacetime features
    (``proj_q`` and ``proj_v`` with a bias when ``qkv_bias``, ``proj_k``
    never; ``q`` scaled by ``hd ** -0.5`` in its dtype).

    Three paths, chosen from what the caller passes:

    * ``rel_source = (encoder, x0)``: the pair features as relative key
      and value.  Where the rel kernels take the shape (``rel_flash``
      "auto", or its alias "always", and the gate of
      :func:`~graphnet_tpu_torch.ops.rel_flash_attention.supported`) they
      run through :func:`rel_flash_attention` (the CUDA kernels for CUDA
      tensors, the plain versions on the CPU) and nothing ``[B, L, L]``
      is stored; otherwise ``encoder(x0)`` is materialised and the dense
      path runs;
    * ``rel_pos_bias [B, L, L, hd]``: the materialised dense path;
    * neither: masked attention through :func:`flash_attention` (scale 1:
      q is already scaled) where its kernels take the head dim, else the
      dense path.

    With ``rel_chunks > 1`` and no rel kernel the biased path runs per
    query tile (:meth:`_chunked_rel`, the JAX package's chunked and
    cached paths): from ``rel_source`` each tile rebuilds its own pair
    features, from ``rel_pos_bias`` it slices the cached tensor.  The
    rel kernels ignore ``rel_chunks``, as in the JAX package.
    """

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        qkv_bias: bool = False,
        rel_chunks: int = 1,
        rel_flash: str = "auto",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if rel_flash not in ("auto", "always", "never"):
            raise ValueError(f"rel_flash must be auto, always or never; got "
                             f"{rel_flash!r}")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.rel_chunks = rel_chunks
        # "always" is the JAX package's name for skipping the TPU memory
        # rule of "auto"; the port has no such rule, so it is "auto"
        self.rel_flash = "auto" if rel_flash == "always" else rel_flash
        self.dtype = dtype
        self.proj_q = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj_k = nn.Linear(dim, dim, bias=False)
        self.proj_v = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def uses_rel_kernel(self, pair_dim: int) -> bool:
        """Whether a biased call with pair features of ``pair_dim`` runs
        through :func:`rel_flash_attention`."""
        return self.rel_flash != "never" and rel_supported(self.head_dim,
                                                           pair_dim)

    def forward(
        self,
        q_in: torch.Tensor,
        k_in: torch.Tensor,
        v_in: torch.Tensor,
        rel_pos_bias: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
        rel_source=None,
    ) -> torch.Tensor:
        B, L, D = q_in.shape
        H, hd = self.num_heads, self.head_dim

        def heads(t):
            return t.reshape(B, L, H, hd).transpose(1, 2)

        q = _scaled_q(heads(linear(self.proj_q, q_in, self.dtype)), hd ** -0.5)
        k = heads(linear(self.proj_k, k_in, self.dtype))
        v = heads(linear(self.proj_v, v_in, self.dtype))
        if rel_source is not None and rel_pos_bias is None:
            encoder, x0 = rel_source
            if self.uses_rel_kernel(encoder.seq_length):
                out = rel_flash_attention(
                    q, k, v, x0, encoder.projection.weight,
                    encoder.projection.bias, key_padding_mask)
                out = out.reshape(B, L, D)
                out = out if self.dtype is None else out.to(self.dtype)
                return linear(self.proj, out, self.dtype)
            if self.rel_chunks > 1:
                out = self._chunked_rel(q, k, v, key_padding_mask,
                                        rel_source=rel_source)
            else:
                out = _dense_rel_attention(q, k, v, key_padding_mask,
                                           encoder(x0))
        elif rel_pos_bias is not None and self.rel_chunks > 1:
            out = self._chunked_rel(q, k, v, key_padding_mask,
                                    rel_cached=rel_pos_bias)
        elif rel_pos_bias is None and flash_supported(hd):
            out = flash_attention(q, k, v, key_padding_mask, scale=1.0)
            out = out.transpose(1, 2)
        else:
            out = _dense_rel_attention(q, k, v, key_padding_mask, rel_pos_bias)
        out = out.reshape(B, L, D)
        out = out if self.dtype is None else out.to(self.dtype)
        return linear(self.proj, out, self.dtype)

    def _chunked_rel(self, q, k, v, key_padding_mask, rel_source=None,
                     rel_cached=None) -> torch.Tensor:
        """The biased path over ``n = max(1, min(rel_chunks, L))`` query
        tiles of ``ceil(L / n)`` rows, each the dense path's math on its
        own rows.  A tile's pair features ``[B, tq, L, hd]`` are sliced
        from ``rel_cached`` or rebuilt by ``encoder(x0, x0[:, s:e])``
        from ``rel_source = (encoder, x0)``.  Under autograd each tile
        runs again in the backward (``torch.utils.checkpoint``), so its
        ``[B, H, tq, L]`` logits and weights, and a rebuilt tile's pair
        features, live one tile at a time: the chunks cut the biased
        block's peak memory in training as in serving.  Returns ``[B, L,
        H, hd]`` in v's dtype."""
        L = q.shape[2]
        n = max(1, min(self.rel_chunks, L))
        tq = -(-L // n)
        # split, not sliced: the backward joins the tiles' gradients in
        # one concatenation instead of a full-size buffer a tile
        q_tiles = q.split(tq, dim=2)
        rel_tiles = (rel_cached.split(tq, dim=1) if rel_cached is not None
                     else [None] * len(q_tiles))
        outs = []
        for i, (qt, rel) in enumerate(zip(q_tiles, rel_tiles)):
            s, e = i * tq, min((i + 1) * tq, L)
            if rel is not None:
                fn, args = _dense_rel_attention, (rel,)
            else:
                fn, args = _rebuilt_rel_tile, (*rel_source, s, e)
            if torch.is_grad_enabled():
                outs.append(checkpoint(fn, qt, k, v, key_padding_mask, *args,
                                       use_reentrant=False))
            else:
                outs.append(fn(qt, k, v, key_padding_mask, *args))
        return torch.cat(outs, dim=1)


def _rebuilt_rel_tile(q, k, v, key_padding_mask, encoder, x0, s, e):
    """The dense path on query rows ``s:e`` (``q`` already cut to them)
    with their pair features rebuilt by ``encoder(x0, x0[:, s:e])``."""
    return _dense_rel_attention(q, k, v, key_padding_mask,
                                encoder(x0, x0[:, s:e]))


class _TransformerBlock(nn.Module):
    """Pre-norm block: ``x + dp1(g1 * attn(norm1(x)))``, then ``x +
    dp2(g2 * mlp(norm2(x)))``, with the layer scales ``gamma_1``,
    ``gamma_2`` when ``init_values`` is given and stochastic depth
    ``drop_path`` (on with ``deterministic=False`` in training mode);
    the norms (eps 1e-6) with fp32 statistics and their result in
    ``dtype``.  ``path_masks``, from :meth:`draw_path_masks`, are the
    two DropPath masks drawn ahead."""

    def __init__(self, dim, attn, mlp_ratio, drop_path, init_values,
                 deterministic, dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = attn
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), deterministic=deterministic,
                       dtype=dtype)
        self.dp1 = DropPath(drop_path, deterministic)
        self.dp2 = DropPath(drop_path, deterministic)
        if init_values is not None:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def draw_path_masks(self, x: torch.Tensor):
        """The masks of ``dp1`` and ``dp2`` for the input ``x``, in the
        order the forward draws them (``None`` each when off)."""
        return self.dp1.draw(x), self.dp2.draw(x)

    def _residuals(self, x, attend, path_masks=None):
        m1, m2 = path_masks if path_masks is not None else (None, None)
        h = attend(layer_norm(self.norm1, x, self.dtype))
        if self.gamma_1 is not None:
            h = self.gamma_1.to(h.dtype) * h
        x = x + self.dp1(h, m1)
        h = self.mlp(layer_norm(self.norm2, x, self.dtype))
        if self.gamma_2 is not None:
            h = self.gamma_2.to(h.dtype) * h
        return x + self.dp2(h, m2)


class BlockRel(_TransformerBlock):
    """Pre-norm block around :class:`AttentionRel` (with q/v bias)."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        mlp_ratio: float = 4.0,
        drop_path: float = 0.0,
        init_values: Optional[float] = None,
        deterministic: bool = True,
        rel_chunks: int = 1,
        rel_flash: str = "auto",
        dtype: Optional[torch.dtype] = None,
    ):
        attn = AttentionRel(dim, num_heads, qkv_bias=True,
                            rel_chunks=rel_chunks, rel_flash=rel_flash,
                            dtype=dtype)
        super().__init__(dim, attn, mlp_ratio, drop_path, init_values,
                         deterministic, dtype)

    def forward(self, x, rel_pos_bias=None, key_padding_mask=None,
                rel_source=None, path_masks=None):
        return self._residuals(x, lambda h: self.attn(
            h, h, h, rel_pos_bias=rel_pos_bias,
            key_padding_mask=key_padding_mask, rel_source=rel_source),
            path_masks)


class Block(_TransformerBlock):
    """Pre-norm block around :class:`MultiHeadAttention`."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        mlp_ratio: float = 4.0,
        drop_path: float = 0.0,
        init_values: Optional[float] = None,
        deterministic: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        attn = MultiHeadAttention(dim, num_heads, dtype=dtype)
        super().__init__(dim, attn, mlp_ratio, drop_path, init_values,
                         deterministic, dtype)

    def forward(self, x, key_padding_mask=None, path_masks=None):
        return self._residuals(x, lambda h: self.attn(h, key_padding_mask),
                               path_masks)
