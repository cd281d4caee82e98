"""Classification task heads (counterpart of
``graphnet_tpu/models/task/classification.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from graphnet_tpu_torch.models.task.task import IdentityTask, StandardLearnedTask


class MulticlassClassificationTask(IdentityTask):
    """Logits head with one column per class."""


class BinaryClassificationTask(StandardLearnedTask):
    """Sigmoid probability head."""

    task_nb_inputs = 1
    default_target_labels = ("target",)
    default_prediction_labels = ("target_pred",)

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.sigmoid(x), x.new_zeros(())


class BinaryClassificationTaskLogits(StandardLearnedTask):
    """Raw-logit head."""

    task_nb_inputs = 1
    default_target_labels = ("target",)
    default_prediction_labels = ("target_pred",)
