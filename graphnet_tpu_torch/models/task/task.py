"""Task heads (counterpart of ``graphnet_tpu/models/task/task.py``).

A task holds the learned affine map from backbone latents to task space
(``affine``), a fixed output transform (``_forward``) and optional
target/inference transforms.  ``forward(latents, inference)`` returns
``(prediction, regularisation_loss)``.  The losses wait for the
training slice of the port.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

EPS = 1.1920929e-07  # float32 eps


def validate_transforms(
    transform_prediction_and_target: Optional[Callable],
    transform_target: Optional[Callable],
    transform_inference: Optional[Callable],
    transform_support: Optional[Tuple[float, float]],
) -> None:
    """Check that target/inference transforms are mutual inverses on a
    test grid."""
    if transform_prediction_and_target is not None and transform_target is not None:
        raise ValueError(
            "Specify at most one of `transform_prediction_and_target` and "
            "`transform_target`"
        )
    if transform_target is None or transform_inference is None:
        return
    if transform_support is not None:
        x_test = np.linspace(transform_support[0], transform_support[1], 10)
    else:
        grid = np.logspace(-6, 6, 13)
        x_test = np.concatenate([-grid[::-1], [0], grid])
    x = torch.as_tensor(x_test, dtype=torch.float32)
    t = transform_inference(transform_target(x)).numpy()
    valid = np.isfinite(t)
    if not np.allclose(t[valid], x_test[valid], rtol=1e-4, atol=1e-4):
        raise ValueError(
            "The provided target/inference transforms are not mutually "
            "inverse."
        )


class Task(nn.Module):
    """Base learned task.

    Subclasses define ``_forward`` and the class attributes
    ``task_nb_inputs`` / ``default_target_labels`` /
    ``default_prediction_labels``.  ``hidden_size`` is the width of the
    backbone latents the affine map reads.
    """

    task_nb_inputs = 1
    default_target_labels: Tuple[str, ...] = ()
    default_prediction_labels: Tuple[str, ...] = ()

    def __init__(
        self,
        hidden_size: int,
        target_labels: Optional[Tuple[str, ...]] = None,
        prediction_labels: Optional[Tuple[str, ...]] = None,
        transform_prediction_and_target: Optional[Callable] = None,
        transform_target: Optional[Callable] = None,
        transform_inference: Optional[Callable] = None,
        transform_support: Optional[Tuple[float, float]] = None,
        node_level: bool = False,
    ):
        super().__init__()
        validate_transforms(
            transform_prediction_and_target,
            transform_target,
            transform_inference,
            transform_support,
        )
        self.target_labels = target_labels
        self.prediction_labels = prediction_labels
        self.transform_prediction_and_target = transform_prediction_and_target
        self.transform_target = transform_target
        self.transform_inference = transform_inference
        # node-level tasks read per-node latents [B, L, d]
        self.node_level = node_level
        self.affine = nn.Linear(hidden_size, self.nb_inputs)

    @property
    def nb_inputs(self) -> int:
        return self.task_nb_inputs

    @property
    def targets(self) -> Tuple[str, ...]:
        t = self.target_labels or self.default_target_labels
        return (t,) if isinstance(t, str) else tuple(t)

    @property
    def predictions(self) -> Tuple[str, ...]:
        p = self.prediction_labels or self.default_prediction_labels
        return (p,) if isinstance(p, str) else tuple(p)

    def _transform_prediction(
        self, pred: torch.Tensor, inference: bool
    ) -> torch.Tensor:
        if self.transform_prediction_and_target is not None and not inference:
            return self.transform_prediction_and_target(pred)
        if self.transform_inference is not None and inference:
            return self.transform_inference(pred)
        return pred

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Map affine outputs to task space; returns (pred, reg_loss)."""
        return x, x.new_zeros(())

    def forward(
        self, latents: torch.Tensor, inference: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        pred, reg = self._forward(self.affine(latents))
        return self._transform_prediction(pred, inference), reg


class StandardLearnedTask(Task):
    """Affine head + fixed transform."""
