"""Input embeddings of DeepIce (counterpart of
``graphnet_tpu/models/components/embedding.py``).

Module and parameter names are the flax ones (``sin_emb``, ``aux_emb``
with its ``embedding`` table, ``mlp_0``, ``mlp_norm``, ``mlp_1``,
``projection``), so :mod:`graphnet_tpu_torch.utils.jax_params` carries
the weights over.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from graphnet_tpu_torch.models.components.layers import layer_norm, linear
from graphnet_tpu_torch.ops.gelu import gelu_exact
from graphnet_tpu_torch.ops.rel_flash_attention import (
    pair_distance,
    sinusoidal_pair_emb,
)


class SinusoidalPosEmb(nn.Module):
    """Fourier features ``[sin(x f), cos(x f)]`` with geometric
    frequencies; with ``scaled`` times a learned scalar ``scale``
    (initialised to ``dim ** -0.5``)."""

    def __init__(self, dim: int = 16, scaled: bool = False):
        super().__init__()
        if dim % 2:
            raise ValueError(f"dim must be even, got {dim}")
        self.dim = dim
        # exp in torch, as the reference GraphNeT computes it (torch's
        # float32 exp is correctly rounded on these values; numpy's and
        # XLA's on the CPU are 1 ulp off for some, and 4096 * x * f
        # makes one ulp of f visible); log(10000) rounded to fp32 first
        half = dim // 2
        log_nf = np.float32(np.log(np.float32(10000.0)))
        step = torch.tensor(np.float32(-log_nf / np.float32(half)))
        freq = torch.exp(torch.arange(half, dtype=torch.float32) * step)
        self.register_buffer("freq", freq, persistent=False)
        if scaled:
            self.scale = nn.Parameter(torch.full((1,), dim ** -0.5))
        else:
            self.scale = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        arg = x[..., None] * self.freq
        emb = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
        return emb if self.scale is None else emb * self.scale


class Embed(nn.Module):
    """A lookup table ``embedding [num, dim]`` (flax ``nn.Embed``;
    initialised N(0, 1) as flax does)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, dim))

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embedding.copy_(
                torch.randn(self.embedding.shape, generator=generator))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embedding[idx]


class FourierEncoder(nn.Module):
    """Per-pulse embedding: sinusoidal features of 4096 * (x, y, z),
    1024 * charge and 4096 * time, the auxiliary flag's table and the
    log10 event length, then ``mlp_0``, an fp32 LayerNorm (eps 1e-5),
    exact GELU and ``mlp_1``.  Input ``[B, L, n_features]`` in the order
    x, y, z, time, charge, auxiliary.  ``dtype`` is the compute dtype of
    the two dense layers; the features and the norm stay fp32."""

    def __init__(
        self,
        seq_length: int = 128,
        output_dim: int = 384,
        scaled: bool = False,
        n_features: int = 6,
        mlp_dim: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if n_features < 4:
            raise ValueError("x, y, z and time are required (n_features >= 4)")
        self.n_features = n_features
        self.dtype = dtype
        self.sin_emb = SinusoidalPosEmb(seq_length, scaled)
        self.sin_emb2 = SinusoidalPosEmb(seq_length // 2, scaled)
        if n_features >= 6:
            self.aux_emb = Embed(2, seq_length // 2)
            hidden = 6 * seq_length
        else:
            hidden = int((n_features + 0.5) * seq_length)
        mlp_dim = mlp_dim or hidden
        self.mlp_0 = nn.Linear(hidden, mlp_dim)
        self.mlp_norm = nn.LayerNorm(mlp_dim, eps=1e-5)
        self.mlp_1 = nn.Linear(mlp_dim, output_dim)

    def forward(self, x: torch.Tensor, seq_lengths: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        parts = [self.sin_emb(4096.0 * x[:, :, :3]).reshape(B, L, -1)]
        if self.n_features >= 5:
            parts.append(self.sin_emb(1024.0 * x[:, :, 4]))
        parts.append(self.sin_emb(4096.0 * x[:, :, 3]))
        if self.n_features >= 6:
            parts.append(self.aux_emb(x[:, :, 5].to(torch.int32).clamp(0, 1)))
        length = torch.log10(seq_lengths.clamp_min(1).float())
        len_emb = self.sin_emb2(length)[:, None, :]
        parts.append(len_emb.expand(B, L, len_emb.shape[-1]))
        h = linear(self.mlp_0, torch.cat(parts, dim=-1), self.dtype)
        h = gelu_exact(layer_norm(self.mlp_norm, h, None))
        return linear(self.mlp_1, h, self.dtype)


class SpacetimeEncoder(nn.Module):
    """Pair features ``[B, Lq, L, seq_length]`` between ``x_query``
    (default all of ``x``) and ``x``: the sinusoidal embedding of the
    clipped signed sqrt spacetime interval, then ``projection`` in
    ``dtype``.  The rel kernels take its projection's weight and bias and
    rebuild the embedding on chip instead."""

    def __init__(self, seq_length: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.seq_length = seq_length
        self.dtype = dtype
        self.projection = nn.Linear(seq_length, seq_length)

    def forward(
        self, x: torch.Tensor, x_query: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        x_query = x if x_query is None else x_query
        emb = sinusoidal_pair_emb(pair_distance(x_query, x), self.seq_length)
        return linear(self.projection, emb, self.dtype)
