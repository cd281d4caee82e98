"""Backbone base class (counterpart of ``graphnet_tpu/models/gnn/gnn.py``).

A backbone maps an :class:`~graphnet_tpu_torch.batch.EventBatch` to
per-event latents ``[B, nb_outputs]`` (or per-node latents ``[B, L, d]``
when the readout is skipped).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graphnet_tpu_torch.batch import EventBatch


def resolve_compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """``"bfloat16"`` -> ``torch.bfloat16``; ``None`` means fp32 throughout."""
    if not name:
        return None
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype


class GNN(nn.Module):
    """Base class for all backbones."""

    @property
    def nb_outputs(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def forward(self, batch: EventBatch) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError
