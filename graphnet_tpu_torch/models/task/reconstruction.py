"""Reconstruction task heads (counterpart of
``graphnet_tpu/models/task/reconstruction.py``).  Only the energy head
is ported so far; it takes ``Task``'s arguments (``loss_function``,
``target_labels``, ``transform_prediction_and_target``, ...)."""

from __future__ import annotations

from typing import Tuple

import torch

from graphnet_tpu_torch.models.task.task import EPS, StandardLearnedTask


class EnergyReconstruction(StandardLearnedTask):
    """softplus(beta=0.05) energy head: ``log(1 + exp(0.05 x)) / 0.05``."""

    task_nb_inputs = 1
    default_target_labels = ("energy",)
    default_prediction_labels = ("energy_pred",)

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        soft = torch.logaddexp(0.05 * x, torch.zeros_like(x))
        return soft / 0.05 + EPS, x.new_zeros(())
