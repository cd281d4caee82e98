"""Task heads (counterpart of ``graphnet_tpu/models/task/task.py``).

A task holds the learned affine map from backbone latents to task space
(``affine``), a fixed output transform (``_forward``), optional
target/inference transforms and a loss function.  ``forward(latents,
inference)`` returns ``(prediction, regularisation_loss)``;
``compute_loss`` evaluates the loss against the batch's truth.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from graphnet_tpu_torch.training.loss_functions import LossFunction
from graphnet_tpu_torch.utils.config import save_config

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
    backbone latents the affine map reads (a config does not carry it:
    ``utils.config.build`` gives each task its backbone's
    ``nb_outputs``); the other arguments are the JAX package's fields, in
    their order.
    """

    task_nb_inputs = 1
    default_target_labels: Tuple[str, ...] = ()
    default_prediction_labels: Tuple[str, ...] = ()

    @save_config(ignore=("hidden_size",))
    def __init__(
        self,
        hidden_size: int,
        loss_function: Optional[LossFunction] = None,
        target_labels: Optional[Tuple[str, ...]] = None,
        prediction_labels: Optional[Tuple[str, ...]] = None,
        transform_prediction_and_target: Optional[Callable] = None,
        transform_target: Optional[Callable] = None,
        transform_inference: Optional[Callable] = None,
        transform_support: Optional[Tuple[float, float]] = None,
        loss_weight: Optional[str] = None,
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
        self.loss_function = loss_function
        # name of a per-event label that weights the loss
        self.loss_weight = loss_weight
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

    def _transform_target_fn(self, target: torch.Tensor) -> torch.Tensor:
        if self.transform_prediction_and_target is not None:
            return self.transform_prediction_and_target(target)
        if self.transform_target is not None:
            return self.transform_target(target)
        return target

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Map affine outputs to task space; returns (pred, reg_loss)."""
        return x, x.new_zeros(())

    def forward(
        self, latents: torch.Tensor, inference: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        pred, reg = self._forward(self.affine(latents))
        return self._transform_prediction(pred, inference), reg

    def compute_loss(
        self,
        pred: torch.Tensor,
        reg: torch.Tensor,
        labels: Dict[str, torch.Tensor],
        weights: Optional[torch.Tensor] = None,
        node_labels: Optional[Dict[str, torch.Tensor]] = None,
        mask: Optional[torch.Tensor] = None,
        event_weights: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Stack the target label columns, transform them, evaluate the
        loss, add the regularisation.

        Node-level tasks: ``pred`` is ``[B, L, d]``, the targets come
        from ``node_labels`` (``[B, L]`` each), and padded nodes are left
        out through zero weights and a mean over the valid count.

        ``event_weights``: optional ``[B]`` multiplier
        (``EventBatch.event_weight``).
        """
        if self.loss_function is None:
            raise ValueError("Task has no loss function")
        if self.node_level:
            if node_labels is None or mask is None:
                raise ValueError("a node-level loss needs node_labels and mask")
            target = torch.stack(
                [node_labels[label] for label in self.targets], dim=-1
            )
            target = self._transform_target_fn(target)
            B, L, d = pred.shape
            w = mask.to(pred.dtype)
            if event_weights is not None:
                # the scale cancels in the normalised mean; only the
                # zeros on padded events matter
                w = w * event_weights[:, None].to(pred.dtype)
            w = w.reshape(B * L)
            elements = self.loss_function(
                pred.reshape(B * L, d),
                target.reshape(B * L, -1),
                return_elements=True,
            )
            # elements may be [B*L] or [B*L, d]: one value per node, so
            # the [B*L] weights pair per node (a bare broadcast of [N]
            # against [N, 1] would build an [N, N] product that silently
            # includes the padded nodes)
            elements = elements.reshape(B * L, -1).mean(dim=-1)
            return (elements * w).sum() / w.sum().clamp_min(1.0) + reg
        cols = []
        for label in self.targets:
            if label not in labels:
                raise KeyError(
                    f"Target label {label!r} not found in batch labels; "
                    f"available: {sorted(labels)}. Check the task's "
                    "target_labels against the dataset's truth columns."
                )
            v = labels[label]
            cols.append(v if v.dim() > 1 else v[:, None])
        target = self._transform_target_fn(torch.cat(cols, dim=1))
        if self.loss_weight is not None:
            weights = labels[self.loss_weight]
        if event_weights is not None:
            weights = (
                event_weights if weights is None else weights * event_weights
            )
        return self.loss_function(pred, target, weights=weights) + reg


class StandardLearnedTask(Task):
    """Affine head + fixed transform."""


class IdentityTask(StandardLearnedTask):
    """Head of configurable width returning its affine outputs."""

    @save_config(ignore=("hidden_size",))
    def __init__(
        self,
        hidden_size: int,
        loss_function: Optional[LossFunction] = None,
        target_labels: Optional[Tuple[str, ...]] = None,
        prediction_labels: Optional[Tuple[str, ...]] = None,
        transform_prediction_and_target: Optional[Callable] = None,
        transform_target: Optional[Callable] = None,
        transform_inference: Optional[Callable] = None,
        transform_support: Optional[Tuple[float, float]] = None,
        loss_weight: Optional[str] = None,
        node_level: bool = False,
        nb_outputs: int = 1,
    ):
        self.nb_outputs = nb_outputs  # read by nb_inputs in Task.__init__
        super().__init__(
            hidden_size, loss_function, target_labels, prediction_labels,
            transform_prediction_and_target, transform_target,
            transform_inference, transform_support, loss_weight, node_level,
        )

    @property
    def nb_inputs(self) -> int:
        return self.nb_outputs

    @property
    def predictions(self) -> Tuple[str, ...]:
        if self.prediction_labels:
            return tuple(self.prediction_labels)
        return tuple(f"target_{i}_pred" for i in range(len(self.targets)))
