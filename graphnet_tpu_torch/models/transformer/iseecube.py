"""ISeeCube, a pure-transformer backbone (counterpart of
``graphnet_tpu/models/transformer/iseecube.py``).

GraphNeT builds it on torchscale's Magneto encoder; the JAX package
writes that encoder out, and so does the port: per pulse the
FourierEncoder plus a learned position embedding, a cls token and
register tokens in front, then pre-norm blocks whose attention adds a
T5 bucketed relative-position bias (one table shared by every block)
and normalises its output before the out-projection, and whose
feed-forward has exact GELU and a LayerNorm before its second layer;
the encoder's final LayerNorm and ISeeCube's own, one after the other.
The cls token's final state is the event's latent.

The biased attention is dense, as in the JAX package (no Pallas kernel
runs there).  Padded keys are masked.  Events padded beyond
``seq_length`` raise, as they do in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.models.components.embedding import FourierEncoder
from graphnet_tpu_torch.models.components.layers import dense_attention
from graphnet_tpu_torch.models.gnn.gnn import GNN
from graphnet_tpu_torch.ops.gelu import gelu_exact
from graphnet_tpu_torch.utils.config import save_config


def t5_relative_buckets(
    relative_position: torch.Tensor, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """T5's bidirectional bucketing of relative positions: half the
    buckets for each sign, exact below a quarter of them, then
    logarithmic up to ``max_distance``.  The logarithm in float32, as
    the JAX package computes it."""
    num_buckets //= 2
    ret = torch.where(relative_position > 0, num_buckets, 0)
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(n.clamp_min(1).to(torch.float32) / max_exact)
    scale = np.float32(np.log(max_distance / max_exact))
    val_if_large = max_exact + (
        log_ratio / float(scale) * (num_buckets - max_exact)
    ).to(torch.int64)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class RelativePositionBias(nn.Module):
    """The additive attention bias ``[1, H, T, T]`` from a learned table
    ``rel_embedding [num_buckets, num_heads]``."""

    def __init__(self, num_buckets: int = 32, max_distance: int = 256,
                 num_heads: int = 12):
        super().__init__()
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.rel_embedding = nn.Parameter(torch.zeros(num_buckets, num_heads))

    def init_parameters(self, generator: torch.Generator) -> None:
        """N(0, 0.02), flax's ``normal(0.02)``."""
        with torch.no_grad():
            self.rel_embedding.copy_(0.02 * torch.randn(
                self.rel_embedding.shape, generator=generator))

    def forward(self, T: int) -> torch.Tensor:
        pos = torch.arange(T, device=self.rel_embedding.device)
        buckets = t5_relative_buckets(pos[None, :] - pos[:, None],
                                      self.num_buckets, self.max_distance)
        return self.rel_embedding[buckets].permute(2, 0, 1)[None]


class _BiasedMHA(nn.Module):
    """torchscale's self-attention with Magneto's sub-norm: separate
    biased q, k, v projections, the dense softmax attention with the
    additive bias (fp32 logits), ``inner_attn_ln`` on its output, the
    ``out`` projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.proj_q = nn.Linear(dim, dim)
        self.proj_k = nn.Linear(dim, dim)
        self.proj_v = nn.Linear(dim, dim)
        self.inner_attn_ln = nn.LayerNorm(dim, eps=1e-5)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor,
                key_padding_mask: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads

        def heads(t):
            return t.reshape(B, T, H, D // H).transpose(1, 2)

        q, k, v = (heads(p(x)) for p in (self.proj_q, self.proj_k,
                                          self.proj_v))
        out = dense_attention(q, k, v, key_padding_mask, attn_bias)
        out = out.transpose(1, 2).reshape(B, T, D)
        return self.out(self.inner_attn_ln(out))


class ISeeCube(GNN):
    """Arguments and defaults are the JAX package's (GraphNeT's): hidden
    384, 16 blocks of 12 heads, MLP 1536, ``seq_length`` 196."""

    @save_config
    def __init__(
        self,
        hidden_dim: int = 384,
        seq_length: int = 196,
        num_layers: int = 16,
        num_heads: int = 12,
        mlp_dim: int = 1536,
        rel_pos_buckets: int = 32,
        max_rel_pos: int = 256,
        num_register_tokens: int = 3,
        scaled_emb: bool = False,
        n_features: int = 6,
    ):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.seq_length = seq_length
        self.num_layers = num_layers
        self.num_register_tokens = num_register_tokens
        self.fourier_ext = FourierEncoder(
            seq_length=seq_length, output_dim=hidden_dim, scaled=scaled_emb,
            n_features=n_features, mlp_dim=mlp_dim)
        self.pos_embedding = nn.Parameter(
            torch.zeros(1, seq_length, hidden_dim))
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, num_register_tokens, hidden_dim))
        self.rel_pos_bias = RelativePositionBias(rel_pos_buckets, max_rel_pos,
                                                 num_heads)
        for i in range(num_layers):
            setattr(self, f"norm1_{i}", nn.LayerNorm(hidden_dim, eps=1e-5))
            setattr(self, f"attn_{i}", _BiasedMHA(hidden_dim, num_heads))
            setattr(self, f"norm2_{i}", nn.LayerNorm(hidden_dim, eps=1e-5))
            setattr(self, f"fc1_{i}", nn.Linear(hidden_dim, mlp_dim))
            setattr(self, f"ffn_ln_{i}", nn.LayerNorm(mlp_dim, eps=1e-5))
            setattr(self, f"fc2_{i}", nn.Linear(mlp_dim, hidden_dim))
        self.encoder_layer_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.layer_norm = nn.LayerNorm(hidden_dim, eps=1e-5)

    @property
    def nb_outputs(self) -> int:
        return self.hidden_dim

    def init_parameters(self, generator: torch.Generator) -> None:
        """The position embedding and the tokens N(0, 0.02)."""
        with torch.no_grad():
            for p in (self.pos_embedding, self.class_token,
                      self.register_tokens):
                p.copy_(0.02 * torch.randn(p.shape, generator=generator))

    def forward(self, batch: EventBatch) -> torch.Tensor:
        x0, mask = batch.x, batch.mask
        B, L, _ = x0.shape
        if L > self.seq_length:
            raise ValueError(
                f"events padded to {L} > seq_length {self.seq_length}")
        x = self.fourier_ext(x0, batch.n_pulses)
        x = x + self.pos_embedding[:, :L]
        D = self.hidden_dim
        x = torch.cat([self.class_token.expand(B, 1, D),
                       self.register_tokens.expand(
                           B, self.num_register_tokens, D),
                       x], dim=1)
        full_mask = torch.cat(
            [torch.ones((B, 1 + self.num_register_tokens), dtype=torch.bool,
                        device=mask.device), mask], dim=1)
        rel_bias = self.rel_pos_bias(x.shape[1])
        for i in range(self.num_layers):
            h = getattr(self, f"norm1_{i}")(x)
            x = x + getattr(self, f"attn_{i}")(h, rel_bias, full_mask)
            h = getattr(self, f"norm2_{i}")(x)
            h = gelu_exact(getattr(self, f"fc1_{i}")(h))
            h = getattr(self, f"fc2_{i}")(getattr(self, f"ffn_ln_{i}")(h))
            x = x + h
        x = self.layer_norm(self.encoder_layer_norm(x))
        return x[:, 0]
