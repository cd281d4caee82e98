"""DeepIce (IceMix), the Kaggle second-place transformer (counterpart of
``graphnet_tpu/models/gnn/icemix.py``).

FourierEncoder per pulse, the SpacetimeEncoder's relative features in
the first ``n_rel`` of ``depth_rel`` BlockRel layers, a learned cls
token, then ``depth`` Blocks with layer scale; the cls token's final
state is the event's latent.  With ``include_dynedge`` the Fourier
features take half the width and a nested DynEdge's node latents
(``dyn_edge``, gelu, norm layers, no readout) the other half.  The relative-bias block runs through the
rel kernels wherever their gate holds (``rel_flash`` "auto", or its
alias "always"), on both devices; with "never", or where the gate fails, the
pair tensor ``[B, L, L, head_size]`` is materialised once and the dense
path runs, or with ``rel_bias_chunks > 1`` the biased attention runs per
query tile on a cached pair tensor or on pair features rebuilt per tile
(``rel_bias_cache``).  The other blocks' attention runs through the
flash kernels.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.models.components.embedding import (
    FourierEncoder,
    SpacetimeEncoder,
)
from graphnet_tpu_torch.models.components.layers import Block, BlockRel
from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
from graphnet_tpu_torch.models.gnn.gnn import GNN, resolve_compute_dtype
from graphnet_tpu_torch.utils.config import save_config


# the largest pair tensor that rel_bias_cache="auto" caches, from fp32
# training steps of the zoo's B_d32 on an H100 (PERF.md): the cached
# route beat the rebuilt one by 3.6-13 % up to 302 MB (B=16, L <= 384)
# in two runs; from 537 MB the two were within 2 % either way, and the
# cached route's peak is higher at every size
REL_CACHE_AUTO_BYTES = 400e6


class DeepIce(GNN):
    """Arguments and defaults are the JAX package's.  ``compute_dtype``
    ("bfloat16" or None) is the dtype of the blocks' and the Fourier
    MLP's matrix products and of the residual stream; the layer norm
    statistics, the softmax and the pair features stay fp32.

    ``include_dynedge`` builds ``dyn_edge``, a :class:`DynEdge` from
    ``dynedge_args`` (default: the JAX package's, with ``nb_inputs =
    n_features``), with ``compute_dtype`` passed down unless the
    arguments name one.  Its convs are built eagerly, so ``nb_inputs``
    must be the events' feature count (the JAX package infers it).

    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    intermediates: every ``Block`` and every bias-free ``BlockRel``,
    never a biased one, as in the JAX package.  A block's DropPath masks
    are drawn before the checkpointed call and passed in, so the
    recompute applies the masks of the forward (the checkpoint restores
    only torch's default generators, not the explicit one they come
    from).

    ``rel_bias_chunks > 1`` where the rel kernels do not run splits the
    biased attention into that many query tiles.  ``rel_bias_cache``
    then says where a tile's pair features come from: "always" slices a
    tensor ``[B, L, L, head_size]`` materialised once a forward,
    "never" rebuilds each tile's rows (in the backward too), and
    "auto" caches when that tensor takes at most
    :data:`REL_CACHE_AUTO_BYTES` (:meth:`caches_rel_bias`).  Where the
    rel kernels run, ``rel_bias_chunks`` and ``rel_bias_cache`` are
    ignored, as in the JAX package; so is ``rel_bias_cache`` with
    ``rel_bias_chunks == 1`` (the dense path materialises the pair
    tensor once).  ``dynedge_args`` is read only with
    ``include_dynedge``.
    """

    @save_config
    def __init__(
        self,
        hidden_dim: int = 384,
        mlp_ratio: int = 4,
        seq_length: int = 192,
        depth: int = 12,
        head_size: int = 32,
        depth_rel: int = 4,
        n_rel: int = 1,
        scaled_emb: bool = False,
        include_dynedge: bool = False,
        dynedge_args: Optional[Dict[str, Any]] = None,
        n_features: int = 6,
        rel_bias_chunks: int = 1,
        rel_bias_cache: str = "auto",
        rel_flash: str = "auto",
        compute_dtype: Optional[str] = None,
        remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.depth_rel = depth_rel
        self.n_rel = n_rel
        self.include_dynedge = include_dynedge
        self.rel_bias_cache = rel_bias_cache
        self.compute_dtype = compute_dtype
        dtype = resolve_compute_dtype(compute_dtype)
        num_heads = hidden_dim // head_size
        self.fourier_ext = FourierEncoder(
            seq_length=seq_length,
            output_dim=hidden_dim // 2 if include_dynedge else hidden_dim,
            scaled=scaled_emb, n_features=n_features, dtype=dtype,
        )
        self.rel_pos = SpacetimeEncoder(head_size, dtype=dtype)
        if include_dynedge:
            args = dict(dynedge_args or dict(
                nb_inputs=n_features,
                nb_neighbours=9,
                post_processing_layer_sizes=(336, hidden_dim // 2),
                dynedge_layer_sizes=(
                    (128, 256),
                    (336, 256),
                    (336, 256),
                    (336, 256),
                ),
                global_pooling_schemes=None,
                activation_layer="gelu",
                add_norm_layer=True,
                skip_readout=True,
            ))
            args.setdefault("compute_dtype", compute_dtype)
            self.dyn_edge = DynEdge(**args)
        for i in range(depth_rel):
            setattr(self, f"sandwich_{i}", BlockRel(
                hidden_dim, num_heads, rel_chunks=rel_bias_chunks,
                rel_flash=rel_flash, dtype=dtype,
            ))
        self.rel_bias_chunks = rel_bias_chunks
        self.cls_token = nn.Parameter(torch.zeros(1, hidden_dim))
        for i in range(depth):
            setattr(self, f"blocks_{i}", Block(
                hidden_dim, num_heads, mlp_ratio=float(mlp_ratio),
                init_values=1.0, dtype=dtype,
            ))

    @property
    def nb_outputs(self) -> int:
        return self.hidden_dim

    def caches_rel_bias(self, B: int, L: int) -> bool:
        """Whether the chunked biased blocks slice a cached pair tensor
        (``B * L * L * head_size`` values, 2 bytes each under bfloat16,
        else 4) rather than rebuild each tile's: "always", "never", or
        under "auto" the tensor's bytes against
        :data:`REL_CACHE_AUTO_BYTES`.  Read only with ``rel_bias_chunks >
        1`` where the rel kernels do not run."""
        if self.rel_bias_cache != "auto":  # any other word rebuilds, as in JAX
            return self.rel_bias_cache == "always"
        size = 2 if self.rel_pos.dtype == torch.bfloat16 else 4
        return B * L * L * self.rel_pos.seq_length * size <= REL_CACHE_AUTO_BYTES

    def init_parameters(self, generator: torch.Generator) -> None:
        """The cls token: N(0, 1), the LeCun normal of a ``[1, D]``
        parameter (fan-in 1), untruncated."""
        with torch.no_grad():
            self.cls_token.copy_(
                torch.randn(self.cls_token.shape, generator=generator))

    def forward(self, batch: EventBatch) -> torch.Tensor:
        x0, mask = batch.x, batch.mask
        B = x0.shape[0]
        x = self.fourier_ext(x0, batch.n_pulses)
        if self.include_dynedge:
            node_latents = self.dyn_edge(batch)
            x = torch.cat([x, node_latents.to(x.dtype)], dim=2)
        rel_pos_bias = rel_source = None
        if self.n_rel > 0 and self.depth_rel > 0:
            if self.sandwich_0.attn.uses_rel_kernel(self.rel_pos.seq_length) \
                    or (self.rel_bias_chunks > 1
                        and not self.caches_rel_bias(x0.shape[0], x0.shape[1])):
                rel_source = (self.rel_pos, x0)
            else:  # materialised once, shared by the biased blocks
                rel_pos_bias = self.rel_pos(x0)
        for i in range(self.depth_rel):
            block = getattr(self, f"sandwich_{i}")
            if i < self.n_rel:
                x = block(x, rel_pos_bias=rel_pos_bias, key_padding_mask=mask,
                          rel_source=rel_source)
            else:
                x = self._block(block, x, mask)
        cls = self.cls_token[None].expand(B, 1, self.hidden_dim).to(x.dtype)
        x = torch.cat([cls, x], dim=1)
        full_mask = torch.cat(
            [torch.ones((B, 1), dtype=torch.bool, device=mask.device), mask],
            dim=1)
        for i in range(self.depth):
            x = self._block(getattr(self, f"blocks_{i}"), x, full_mask)
        return x[:, 0].float()

    def _block(self, block, x: torch.Tensor,
               key_padding_mask: torch.Tensor) -> torch.Tensor:
        """A bias-free block, recomputed in the backward with ``remat``
        (its DropPath masks drawn first, so both passes apply them)."""
        if not (self.remat and torch.is_grad_enabled()):
            return block(x, key_padding_mask=key_padding_mask)
        return checkpoint(block, x, key_padding_mask=key_padding_mask,
                          path_masks=block.draw_path_masks(x),
                          use_reentrant=False)
