"""Loss functions (counterpart of ``graphnet_tpu/training/
loss_functions.py``).

Ported so far: the base class and the regression losses DynEdge's
energy task uses (``MSELoss``, ``RMSELoss``, ``LogCoshLoss``).  The
classification and von-Mises-Fisher losses wait for the backbones that
need them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_LOG_2 = math.log(2.0)


class LossFunction:
    """Base class: ``__call__(prediction, target, weights) -> scalar``,
    or the elementwise terms with ``return_elements=True``.  Stateless:
    instances hold only static configuration."""

    def __call__(
        self,
        prediction: torch.Tensor,
        target: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        return_elements: bool = False,
    ) -> torch.Tensor:
        elements = self._forward(prediction, target)
        if weights is not None:
            # per-event weights are [B]; elements may be [B] or [B, d]:
            # align by appending singleton axes (a bare broadcast of [B]
            # against [B, 1] would give a bogus [B, B] outer product)
            if weights.dim() < elements.dim():
                weights = weights.reshape(
                    weights.shape + (1,) * (elements.dim() - weights.dim())
                )
            elements = elements * weights
        return elements if return_elements else elements.mean()

    def _forward(
        self, prediction: torch.Tensor, target: torch.Tensor
    ) -> torch.Tensor:
        raise NotImplementedError


class MSELoss(LossFunction):
    def _forward(self, prediction, target):
        if target.dim() != prediction.dim():
            target = target.reshape(prediction.shape)
        return ((prediction - target) ** 2).mean(dim=-1)


class RMSELoss(MSELoss):
    def _forward(self, prediction, target):
        return torch.sqrt(super()._forward(prediction, target))


class LogCoshLoss(LossFunction):
    """Stable ``log cosh(x) = x + softplus(-2x) - log 2``."""

    @staticmethod
    def _log_cosh(x: torch.Tensor) -> torch.Tensor:
        return x + F.softplus(-2.0 * x) - _LOG_2

    def _forward(self, prediction, target):
        if target.dim() < prediction.dim():
            target = target[..., None]
        return self._log_cosh(prediction - target)
