"""Reconstruction task heads (counterpart of
``graphnet_tpu/models/task/reconstruction.py``).  Ported so far: the
energy head, the 3D direction head with its concentration and the
zenith heads; each takes ``Task``'s arguments (``loss_function``,
``target_labels``, ``transform_prediction_and_target``, ...)."""

from __future__ import annotations

import math
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


class DirectionReconstructionWithKappa(StandardLearnedTask):
    """3D unit direction and the von Mises-Fisher concentration
    ``kappa = |x| + EPS`` of the affine output ``x [B, 3]``."""

    task_nb_inputs = 3
    default_target_labels = ("direction",)
    default_prediction_labels = (
        "dir_x_pred",
        "dir_y_pred",
        "dir_z_pred",
        "direction_kappa",
    )

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        kappa = torch.linalg.vector_norm(x, dim=1) + EPS
        vec = x / kappa[:, None]
        return torch.cat([vec, kappa[:, None]], dim=1), x.new_zeros(())


class ZenithReconstruction(StandardLearnedTask):
    """Zenith as ``sigmoid(x) * pi``."""

    task_nb_inputs = 1
    default_target_labels = ("zenith",)
    default_prediction_labels = ("zenith_pred",)

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.sigmoid(x[:, :1]) * math.pi, x.new_zeros(())


class ZenithReconstructionWithKappa(ZenithReconstruction):
    """Zenith and its concentration ``|x_1| + EPS``."""

    task_nb_inputs = 2
    default_prediction_labels = ("zenith_pred", "zenith_kappa")

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        angle, _ = ZenithReconstruction._forward(self, x[:, :1])
        kappa = torch.abs(x[:, 1]) + EPS
        return torch.stack([angle[:, 0], kappa], dim=1), x.new_zeros(())
