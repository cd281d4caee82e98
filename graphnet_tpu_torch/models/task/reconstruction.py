"""Reconstruction task heads (counterpart of
``graphnet_tpu/models/task/reconstruction.py``): all thirteen of its
heads, each taking ``Task``'s arguments (``loss_function``,
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
        return _softplus_energy(x), x.new_zeros(())


class EnergyReconstructionWithPower(StandardLearnedTask):
    """Energy as ``10^(x + 1)``."""

    task_nb_inputs = 1
    default_target_labels = ("energy",)
    default_prediction_labels = ("energy_pred",)

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.pow(10.0, x[:, :1] + 1.0), x.new_zeros(())


class EnergyTCReconstruction(StandardLearnedTask):
    """Track and cascade energies, each by the softplus energy head."""

    task_nb_inputs = 2
    default_target_labels = ("energy_track", "energy_cascade")
    default_prediction_labels = ("energy_track_pred", "energy_cascade_pred")

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return _softplus_energy(x), x.new_zeros(())


class EnergyReconstructionWithUncertainty(EnergyReconstruction):
    """The softplus energy and the affine output ``x_1`` as its
    log-variance."""

    task_nb_inputs = 2
    default_prediction_labels = ("energy_pred", "energy_sigma")

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        energy = _softplus_energy(x[:, :1])
        return torch.stack([energy[:, 0], x[:, 1]], dim=1), x.new_zeros(())


class VertexReconstruction(StandardLearnedTask):
    """Vertex position (x, y, z scaled by 100) and interaction time."""

    task_nb_inputs = 4
    default_target_labels = ("vertex",)
    default_prediction_labels = (
        "position_x_pred",
        "position_y_pred",
        "position_z_pred",
        "interaction_time_pred",
    )

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scale = torch.tensor([1e2, 1e2, 1e2, 1.0], dtype=x.dtype, device=x.device)
        return x * scale, x.new_zeros(())


class PositionReconstruction(StandardLearnedTask):
    """Position x, y, z scaled by 100."""

    task_nb_inputs = 3
    default_target_labels = ("position",)
    default_prediction_labels = (
        "position_x_pred",
        "position_y_pred",
        "position_z_pred",
    )

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return x * 1e2, x.new_zeros(())


class TimeReconstruction(StandardLearnedTask):
    """Interaction time: the affine output as it is."""

    task_nb_inputs = 1
    default_target_labels = ("interaction_time",)
    default_prediction_labels = ("interaction_time_pred",)


class InelasticityReconstruction(StandardLearnedTask):
    """Inelasticity as ``sigmoid(x)``."""

    task_nb_inputs = 1
    default_target_labels = ("inelasticity",)
    default_prediction_labels = ("inelasticity_pred",)

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.sigmoid(x), x.new_zeros(())


def _softplus_energy(x: torch.Tensor) -> torch.Tensor:
    """``softplus(0.05 x) / 0.05 + EPS``: torch's softplus with beta 0.05."""
    return torch.logaddexp(0.05 * x, torch.zeros_like(x)) / 0.05 + EPS


class AzimuthReconstructionWithKappa(StandardLearnedTask):
    """Azimuth in ``[0, 2 pi)`` from the affine ``(x, y)`` and its
    concentration ``kappa = |(x, y)| + EPS``."""

    task_nb_inputs = 2
    default_target_labels = ("azimuth",)
    default_prediction_labels = ("azimuth_pred", "azimuth_kappa")

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        kappa = torch.linalg.vector_norm(x, dim=1) + EPS
        angle = torch.atan2(x[:, 1], x[:, 0])
        angle = torch.where(angle < 0, angle + 2 * math.pi, angle)
        return torch.stack([angle, kappa], dim=1), x.new_zeros(())


class AzimuthReconstruction(AzimuthReconstructionWithKappa):
    """The azimuth alone, with ``1e-3`` times the KL term ``mean(sigma^2 -
    log sigma - 1)`` of ``sigma^2 = 1 / kappa`` as its regularisation."""

    default_prediction_labels = ("azimuth_pred",)

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        res, _ = super()._forward(x)
        angle, kappa = res[:, :1], res[:, 1]
        sigma = torch.sqrt(1.0 / kappa)
        kl_loss = (sigma ** 2 - torch.log(sigma) - 1.0).mean()
        return angle, 1e-3 * kl_loss


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
