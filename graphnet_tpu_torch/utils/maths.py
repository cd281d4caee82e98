"""Math helpers (counterpart of ``graphnet_tpu/utils/maths.py``)."""

from __future__ import annotations

import torch


def eps_like(x: torch.Tensor) -> torch.Tensor:
    """Machine epsilon of ``x``'s dtype, as a scalar tensor of that dtype
    on ``x``'s device."""
    return torch.tensor(torch.finfo(x.dtype).eps, dtype=x.dtype,
                        device=x.device)
