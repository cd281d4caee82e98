"""Trainer: fit, validate and predict a StandardModel on one device
(counterpart of ``graphnet_tpu/training/trainer.py``).

The JAX Trainer's single-device path: one optimiser step per batch,
Adam with eps 1e-3 and the canonical piecewise-linear schedule, early
stopping on the validation loss with the best weights restored, and the
same ``state_dict.pkl`` (the JAX parameter tree, pickled) on both sides.
The model holds its parameters and its device; batches are moved to it.
Not ported yet: meshes and sharding, ``steps_per_dispatch``, SWA/EMA,
orbax checkpoints and ``resume``, profiling, prefetch, loggers.
"""

from __future__ import annotations

import logging
import pickle
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.training.callbacks import (
    EarlyStopping,
    Schedule,
    piecewise_linear_schedule,
)
from graphnet_tpu_torch.utils.jax_params import (
    load_jax_state_dict,
    params_to_jax,
)

logger = logging.getLogger(__name__)

OptimizerFactory = Callable[
    [Iterable[torch.nn.Parameter]], torch.optim.Optimizer
]


def clip_by_global_norm(
    params: Sequence[torch.nn.Parameter], max_norm: float
) -> torch.Tensor:
    """``optax.clip_by_global_norm`` on the parameters' gradients, in
    place: unless the global norm is below ``max_norm``, every gradient
    is scaled by ``max_norm / norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Returns the norm; no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


class Trainer:
    """Fit / validate / predict a :class:`StandardModel`."""

    def __init__(
        self,
        model: StandardModel,
        optimizer: Optional[OptimizerFactory] = None,
        learning_rate: float = 1e-3,
        schedule: Optional[Schedule] = None,
        clip_grad_norm: Optional[float] = None,
        seed: int = 42,
    ) -> None:
        """Args:
        model: the port model, already on its device.
        optimizer: a function of the parameters returning a torch
            optimizer (``functools.partial(torch.optim.SGD, lr=0.1)``);
            the default is ``torch.optim.Adam(lr=learning_rate,
            eps=1e-3)``, which is ``optax.adam(eps=1e-3)``: eps outside
            the square root, bias corrections counted from step 1.
        schedule: learning rate as a function of the optimiser step
            (e.g. :func:`piecewise_linear_schedule`).
        clip_grad_norm: clip the gradients' global norm to this, as
            ``optax.clip_by_global_norm`` does.
        seed: the JAX Trainer's seed argument; the port's model draws its
            initial weights from ``StandardModel(seed=...)``, and no
            layer ported so far is stochastic.
        """
        self.model = model
        self._factory = optimizer
        self._lr = learning_rate
        self._schedule = schedule
        self.clip_grad_norm = clip_grad_norm
        self.seed = seed
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _build_optimizer(self) -> None:
        if self._factory is None:
            self.optimizer = torch.optim.Adam(
                self.model.parameters(), lr=self._lr, eps=1e-3
            )
        else:
            self.optimizer = self._factory(self.model.parameters())
        self._attach_schedule()

    def _attach_schedule(self) -> None:
        """Drive the optimizer's learning rate by ``schedule(step)`` from
        the current step on (a ``LambdaLR`` counts from 0)."""
        self.scheduler = None
        if self._schedule is None:
            return
        offset, schedule = self.step, self._schedule
        lambdas = [
            lambda s, base=g.get("initial_lr", g["lr"]): (
                schedule(s + offset) / base
            )
            for g in self.optimizer.param_groups
        ]
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambdas
        )

    def _current_lr(self) -> float:
        """Learning rate of the next step (NaN for a custom optimizer
        without a schedule: the Trainer cannot know its rate)."""
        if self._schedule is not None:
            return float(self._schedule(self.step))
        if self._factory is not None:
            return float("nan")
        return float(self._lr)

    # ------------------------------------------------------------------
    def init(self, example_batch: Optional[EventBatch] = None):
        """Build the optimizer and its state, from step 0.  The model
        already holds its parameters, so ``example_batch`` (the JAX
        Trainer's argument, which shapes ``model.init``) is not read."""
        self.step = 0
        self._build_optimizer()
        return self.optimizer

    def train_step(self, batch: EventBatch) -> torch.Tensor:
        """One optimiser step on ``batch`` (moved to the model's device);
        returns the loss as a 0-d tensor on the device (no host sync)."""
        if self.optimizer is None:
            self.init(batch)
        batch = batch.to(self.device)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.loss_from_batch(self.model(batch), batch)
        loss.backward()
        if self.clip_grad_norm is not None:
            clip_by_global_norm(
                list(self.model.parameters()), self.clip_grad_norm
            )
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1
        return loss.detach()

    def eval_step(self, batch: EventBatch) -> torch.Tensor:
        """The loss on ``batch``, without gradients (0-d, on the device)."""
        self.model.eval()
        with torch.no_grad():
            batch = batch.to(self.device)
            return self.model.loss_from_batch(self.model(batch), batch)

    # ------------------------------------------------------------------
    def fit(
        self,
        train_loader,
        val_loader=None,
        *,
        max_epochs: int = 10,
        early_stopping_patience: int = 5,
        use_default_schedule: bool = True,
        log_every_n_steps: int = 25,
    ) -> Dict[str, List[float]]:
        """Train for up to ``max_epochs`` over ``train_loader`` (an
        iterable of :class:`EventBatch` with ``len()``); returns the
        history ``{"train_loss": [...], "val_loss": [...]}``.

        ``train_loss`` is the mean of the epoch's per-step losses,
        ``val_loss`` the event-count-weighted mean over ``val_loader``.
        With a validation loader, training stops after
        ``early_stopping_patience`` epochs without a new best, and the
        best epoch's weights are restored at the end.

        ``use_default_schedule`` (when no schedule was given): the
        canonical DynEdge schedule, factors ``[1e-2, 1, 1e-2]`` at steps
        ``[0, steps_per_epoch // 2, steps_per_epoch * max_epochs]``,
        with the default Adam, as the JAX Trainer does (it replaces a
        custom optimizer too).
        """
        if use_default_schedule and self._schedule is None:
            steps_per_epoch = max(len(train_loader), 1)
            self._schedule = piecewise_linear_schedule(
                self._lr,
                [0, steps_per_epoch // 2, steps_per_epoch * max_epochs],
                [1e-2, 1.0, 1e-2],
            )
            if self.optimizer is None or self._factory is not None:
                self._factory = None
                self._build_optimizer()
            else:  # the default Adam keeps its state
                self._attach_schedule()
        elif self.optimizer is None:
            self._build_optimizer()

        history: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}
        stopper = EarlyStopping(patience=early_stopping_patience)
        best_state = None
        for epoch in range(max_epochs):
            t0 = time.perf_counter()
            losses, n_events = [], 0
            for i, batch in enumerate(train_loader):
                n_events += batch.batch_size
                loss = self.train_step(batch)
                losses.append(loss)
                if (i + 1) % log_every_n_steps == 0:
                    logger.info(
                        "epoch %d step %d: train_loss=%.4f lr=%.3e",
                        epoch, i + 1, float(loss), self._current_lr(),
                    )
            # one host sync per epoch
            train_loss = float(torch.stack(losses).mean())
            history["train_loss"].append(train_loss)
            seconds = time.perf_counter() - t0
            msg = (
                f"epoch {epoch}: train_loss={train_loss:.4f} ({seconds:.1f}s, "
                f"{n_events / max(seconds, 1e-9):.0f} events/s)"
            )
            if val_loader is not None:
                vals, counts = [], []
                for batch in val_loader:
                    counts.append(batch.batch_size)
                    vals.append(self.eval_step(batch))
                w = torch.tensor(counts, dtype=torch.float32, device=self.device)
                val_loss = float((torch.stack(vals) * w).sum() / w.sum())
                history["val_loss"].append(val_loss)
                msg += f" val_loss={val_loss:.4f}"
                if stopper.update(val_loss, epoch):
                    best_state = {
                        k: v.detach().clone()
                        for k, v in self.model.state_dict().items()
                    }
                if stopper.should_stop:
                    logger.info(
                        "early stopping at epoch %d (best epoch %d)",
                        epoch, stopper.best_epoch,
                    )
                    logger.info(msg)
                    break
            logger.info(msg)
        if best_state is not None:
            self.model.load_state_dict(best_state)
        return history

    def predict(self, loader) -> List[np.ndarray]:
        """Per-task predictions (inference transforms applied),
        concatenated over the batches, on the host."""
        self.model.eval()
        per_task: Optional[List[List[np.ndarray]]] = None
        with torch.inference_mode():
            for batch in loader:
                outs = self.model(batch.to(self.device), inference=True)
                if per_task is None:
                    per_task = [[] for _ in outs]
                for chunks, (pred, _) in zip(per_task, outs):
                    chunks.append(pred.float().cpu().numpy())
        if per_task is None:
            raise ValueError("empty loader")
        return [np.concatenate(chunks, axis=0) for chunks in per_task]

    def predict_as_dataframe(
        self,
        loader,
        additional_attributes: Optional[List[str]] = None,
    ):
        """Predictions and the requested truth attributes as a pandas
        DataFrame, one column per prediction label.  Node-level tasks
        give one row per valid pulse, with the event attributes repeated
        per pulse.  pandas is imported here, so the rest of the port
        does not need it."""
        import pandas as pd

        additional_attributes = additional_attributes or []
        columns = self.model.prediction_labels
        node_level = any(t.node_level for t in self.model.tasks)
        rows: List[np.ndarray] = []
        attrs: Dict[str, List[np.ndarray]] = {
            a: [] for a in additional_attributes
        }
        self.model.eval()
        with torch.inference_mode():
            for batch in loader:
                outs = [
                    pred.float().cpu().numpy()
                    for pred, _ in self.model(
                        batch.to(self.device), inference=True
                    )
                ]
                if node_level:
                    mask = batch.mask.cpu().numpy()
                    reps = batch.n_pulses.cpu().numpy()
                    rows.append(np.concatenate([
                        o[mask] if o.ndim == 3 else np.repeat(o, reps, axis=0)
                        for o in outs
                    ], axis=1))
                else:
                    reps = None
                    rows.append(np.concatenate(outs, axis=1))
                for a in additional_attributes:
                    v = batch.labels[a].cpu().numpy()
                    attrs[a].append(v if reps is None else np.repeat(v, reps, axis=0))
        if not rows:
            raise ValueError("empty loader")
        data = np.concatenate(rows, axis=0)
        if data.shape[1] != len(columns):
            raise ValueError(
                f"prediction width {data.shape[1]} != labels {columns}"
            )
        df = pd.DataFrame(data, columns=columns)
        for a in additional_attributes:
            df[a] = np.concatenate(attrs[a], axis=0)
        return df

    # ------------------------------------------------------------------
    def save_state_dict(self, path: str) -> None:
        """Write the parameters as the JAX Trainer's ``state_dict.pkl``
        (the JAX parameter tree of numpy arrays, pickled), which both
        packages' ``DeploymentModule``s load."""
        with open(path, "wb") as f:
            pickle.dump(params_to_jax(self.model.state_dict()), f)

    def load_state_dict(self, path: str) -> None:
        """Load a ``state_dict.pkl`` of either package into the model;
        the optimizer starts with fresh state, as in the JAX Trainer."""
        self.model.load_state_dict(
            load_jax_state_dict(path, expected=self.model.state_dict())
        )
        self._build_optimizer()
