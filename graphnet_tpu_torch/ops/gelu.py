"""Exact-erf GELU (counterpart of ``graphnet_tpu/ops/gelu.py``).

The JAX package writes ``x * 0.5 * (1 + erf(x / sqrt(2)))`` with a
recompute VJP to keep XLA from storing fp32 residuals.  ``F.gelu`` with
its default ``approximate="none"`` is the same function, computes
internally in fp32 for a bf16 input and rounds once, and its autograd
keeps only the input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """``x * Phi(x)`` with the exact normal CDF, in x's dtype."""
    return F.gelu(x)
