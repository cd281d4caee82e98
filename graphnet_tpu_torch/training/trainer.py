"""Trainer: fit, validate and predict a model on one device (counterpart
of ``graphnet_tpu/training/trainer.py``).  The model is a
:class:`~graphnet_tpu_torch.models.standard_model.StandardModel` or any
module with its contract (:class:`TrainableModel`): a
:class:`~graphnet_tpu_torch.models.normalizing_flow.NormalizingFlow` or
``SphericalFlow``, whose forward returns one array, the per-event NLLH.

The JAX Trainer's single-device path: one optimiser step per batch,
Adam with eps 1e-3 and the canonical piecewise-linear schedule, early
stopping on the validation loss with the best weights restored, SWA or
EMA weight averaging, resumable checkpoints (``checkpoint_dir``,
``fit(resume=True)``; the port's own format, ``torch.save``), a metric
logger, a progress bar and a profile of the first epoch; and the same
``state_dict.pkl`` (the JAX parameter tree, pickled) on both sides.
The model holds its parameters and its device; batches are moved to it.

Stochastic layers (dropout, DropPath with ``deterministic=False``) draw
from one ``torch.Generator`` on the model's device, seeded anew before
each step from ``(seed + 1, step)``: the counterpart of the JAX
Trainer's ``fold_in(PRNGKey(seed + 1), step)``, so a resumed run draws
the masks an unbroken one draws.

``steps_per_dispatch=k`` keeps the JAX Trainer's step order: batches
are buffered per signature and each group of k runs as k optimiser
steps in a row, the groups' leftovers one by one at the epoch's end; a
:class:`~graphnet_tpu_torch.batch.StackedBatches` is copied to the
device at once and runs as its k steps.  Each step is an ordinary step
(its own generator seed, schedule step and SWA / EMA update), so the
numbers equal k single steps in that order.  ``fit(prefetch=N)`` streams
every epoch through one :class:`~graphnet_tpu_torch.data.prefetch.
EpochPipeline`.

Not ported: meshes and sharding (``mesh``, ``data_axis``,
``model_axis``, ``param_sharding``).
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Protocol,
                    Sequence)

import numpy as np
import torch

from graphnet_tpu_torch.batch import EventBatch, StackedBatches
from graphnet_tpu_torch.models.components import stochastic
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


class TrainableModel(Protocol):
    """What the Trainer reads of its model (an ``nn.Module``): ``model(
    batch, inference=...)`` returns per-task ``(prediction,
    regularisation)`` pairs or one array (a density's per-event NLLH);
    ``loss_from_batch(outputs, batch)`` the loss; ``prediction_labels``
    and ``tasks`` (each with ``node_level``) name the predictions."""

    def loss_from_batch(self, outputs: Any, batch: EventBatch) -> torch.Tensor:
        ...

    @property
    def prediction_labels(self) -> List[str]:
        ...

    @property
    def tasks(self) -> Sequence[Any]:
        ...


def prediction_arrays(outputs: Any) -> List[torch.Tensor]:
    """The predictions of a forward's outputs: each task's prediction, or
    the one array of a model that returns one (``[B]`` made ``[B, 1]``),
    as the JAX Trainer's ``predict_step``."""
    if isinstance(outputs, torch.Tensor):
        return [outputs if outputs.dim() > 1 else outputs[:, None]]
    return [pred for pred, _ in outputs]


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


def _save(payload: Dict[str, Any], path: str) -> None:
    """``torch.save`` through a temporary file, so a run cut mid-write
    leaves the previous checkpoint whole."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


class Trainer:
    """Fit / validate / predict a :class:`TrainableModel`."""

    def __init__(
        self,
        model: TrainableModel,
        optimizer: Optional[OptimizerFactory] = None,
        learning_rate: float = 1e-3,
        schedule: Optional[Schedule] = None,
        clip_grad_norm: Optional[float] = None,
        seed: int = 42,
        checkpoint_dir: Optional[str] = None,
        averaging: Optional[str] = None,
        ema_decay: float = 0.999,
        metric_logger: Optional[Any] = None,
        progress_bar: bool = False,
        steps_per_dispatch: int = 1,
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
        seed: the stochastic layers' generator is seeded from ``(seed +
            1, step)`` before each step; the model draws its initial
            weights from ``StandardModel(seed=...)``.
        checkpoint_dir: ``fit`` writes ``last`` (the whole training
            state) after each epoch and ``best`` (the parameters) after
            each improved validation loss there.
        averaging: None, ``"swa"`` (equal-weight running average) or
            ``"ema"`` (decay ``ema_decay``) of the parameters, updated
            after each optimiser step and swapped in at the end of
            ``fit``, where they supersede the best-weights restore.
        metric_logger: any object with ``log_metrics(metrics, step)``,
            or a wandb-style one with ``log(metrics, step=...)``.
        progress_bar: a tqdm bar over each epoch's batches (tqdm is
            imported only then).
        steps_per_dispatch: ``fit`` runs the batches of one signature in
            groups of this many steps, in the JAX Trainer's order (the
            JAX Trainer runs a group in one device dispatch; here it is
            a loop of ordinary steps).
        """
        if averaging not in (None, "swa", "ema"):
            raise ValueError(f"averaging must be None, swa or ema; got "
                             f"{averaging!r}")
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1; got "
                             f"{steps_per_dispatch}")
        self.model = model
        self._factory = optimizer
        self._lr = learning_rate
        self._schedule = schedule
        self.clip_grad_norm = clip_grad_norm
        self.seed = seed
        self.checkpoint_dir = checkpoint_dir
        self.averaging = averaging
        self.ema_decay = ema_decay
        self.metric_logger = metric_logger
        self.progress_bar = progress_bar
        self.steps_per_dispatch = steps_per_dispatch
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
        self.step = 0
        self._generator: Optional[torch.Generator] = None
        self._avg: Optional[Dict[str, torch.Tensor]] = None
        self._avg_count = 0

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

    def _log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if self.metric_logger is None:
            return
        if hasattr(self.metric_logger, "log_metrics"):
            self.metric_logger.log_metrics(metrics, step=step)
        elif hasattr(self.metric_logger, "log"):  # wandb-style
            self.metric_logger.log(metrics, step=step)

    def step_generator(self) -> torch.Generator:
        """The stochastic layers' generator for the current step, on the
        model's device, seeded from ``(seed + 1, step)``."""
        if self._generator is None or self._generator.device != self.device:
            self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(
            stochastic.step_seed(self.seed + 1, self.step))
        return self._generator

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
        # seeded at the step's first draw: a model with no stochastic
        # layer on never seeds it
        with stochastic.use_generator(self.step_generator):
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
        self._update_averages()
        return loss.detach()

    def train_steps(self, batches) -> torch.Tensor:
        """One optimiser step per batch, in order: a list of batches of
        one signature, or a :class:`StackedBatches` (copied to the
        device at once, then stepped on views of it).  Returns the
        ``[k]`` losses on the device."""
        if isinstance(batches, StackedBatches):
            batches = batches.to(self.device).unstack()
        return torch.stack([self.train_step(b) for b in batches])

    def eval_step(self, batch: EventBatch) -> torch.Tensor:
        """The loss on ``batch``, without gradients (0-d, on the device)."""
        self.model.eval()
        with torch.no_grad():
            batch = batch.to(self.device)
            return self.model.loss_from_batch(self.model(batch), batch)

    def _update_averages(self) -> None:
        """One SWA / EMA update with the parameters after a step; the
        first step's parameters seed the average."""
        if self.averaging is None:
            return
        with torch.no_grad():
            params = dict(self.model.named_parameters())
            if self._avg is None:
                self._avg = {n: p.detach().clone() for n, p in params.items()}
                self._avg_count = 1
                return
            if self.averaging == "swa":
                n = self._avg_count
                for name, a in self._avg.items():
                    a.copy_(a + (params[name] - a) / (n + 1))
                self._avg_count += 1
            else:
                d = self.ema_decay
                for name, a in self._avg.items():
                    a.copy_(d * a + (1.0 - d) * params[name])

    def _swap_in_average(self) -> None:
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(self._avg[name])

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
        ckpt_best: bool = True,
        resume: bool = False,
        profile_dir: Optional[str] = None,
        prefetch: int = 0,
    ) -> Dict[str, List[float]]:
        """Train for up to ``max_epochs`` over ``train_loader`` (an
        iterable of :class:`EventBatch` with ``len()``); returns the
        history ``{"train_loss": [...], "val_loss": [...]}``.

        ``train_loss`` is the mean of the epoch's per-step losses,
        ``val_loss`` the event-count-weighted mean over ``val_loader``.
        With a validation loader, training stops after
        ``early_stopping_patience`` epochs without a new best, and the
        best epoch's weights are restored at the end (unless SWA / EMA
        weights are swapped in).

        ``use_default_schedule`` (when no schedule was given): the
        canonical DynEdge schedule, factors ``[1e-2, 1, 1e-2]`` at steps
        ``[0, steps_per_epoch // 2, steps_per_epoch * max_epochs]``,
        with the default Adam, as the JAX Trainer does (it replaces a
        custom optimizer too).

        ``resume=True`` restores ``<checkpoint_dir>/last`` where it
        exists (parameters, optimiser state, step, epoch and the
        average) and goes on from the epoch after it.  ``profile_dir``:
        a ``torch.profiler`` trace of the first epoch's steps, written
        there as ``trace.json``.

        ``prefetch > 0`` streams every epoch through one
        :class:`~graphnet_tpu_torch.data.prefetch.EpochPipeline`
        (``prefetch`` items deep, from ``start_epoch`` on a resume): a
        producer thread runs the loader and copies the batches to the
        model's device, building epoch e+1's first batches while the
        device finishes epoch e.
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
        last_ckpt = (os.path.join(self.checkpoint_dir, "last")
                     if self.checkpoint_dir else None)
        start_epoch = 0
        if resume and last_ckpt and os.path.exists(last_ckpt):
            start_epoch = self.load_train_state(last_ckpt) + 1
            logger.info("resumed from %s at epoch %d", last_ckpt, start_epoch)

        pipeline = None
        if prefetch:
            from graphnet_tpu_torch.data.prefetch import EpochPipeline

            pipeline = EpochPipeline(train_loader, max_epochs,
                                     prefetch=prefetch, device=self.device,
                                     start_epoch=start_epoch)
        profiler = None
        if profile_dir is not None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        try:
            for epoch in range(start_epoch, max_epochs):
                # the pipeline's producer calls set_epoch itself
                if pipeline is None and hasattr(train_loader, "set_epoch"):
                    train_loader.set_epoch(epoch)
                t0 = time.perf_counter()
                losses, n_events = [], 0
                iterator = (pipeline.epoch() if pipeline is not None
                            else train_loader)
                if self.progress_bar:
                    from tqdm.auto import tqdm

                    iterator = tqdm(iterator, total=len(train_loader),
                                    desc=f"epoch {epoch}", unit="batch",
                                    leave=False)
                groups: Dict[Any, List[EventBatch]] = {}
                for i, batch in enumerate(iterator):
                    n_events += batch.batch_size
                    if isinstance(batch, StackedBatches):
                        losses.append(self.train_steps(batch))
                        continue
                    if self.steps_per_dispatch > 1:
                        # buffered per signature, run k at a time
                        key = batch.signature()
                        group = groups.setdefault(key, [])
                        group.append(batch)
                        if len(group) < self.steps_per_dispatch:
                            continue
                        del groups[key]
                        loss = self.train_steps(group)
                    else:
                        loss = self.train_step(batch)
                    losses.append(loss)
                    if (i + 1) % log_every_n_steps == 0:
                        last = float(loss.reshape(-1)[-1])
                        lr = self._current_lr()
                        if self.progress_bar:
                            iterator.set_postfix(train_loss=f"{last:.4f}",
                                                 refresh=False)
                        else:
                            logger.info("epoch %d step %d: train_loss=%.4f "
                                        "lr=%.3e", epoch, i + 1, last, lr)
                        metrics = {"train_loss": last}
                        if np.isfinite(lr):
                            metrics["lr"] = lr
                        self._log_metrics(metrics, step=self.step)
                # the groups' leftovers, one step each
                for group in groups.values():
                    losses.extend(self.train_step(b) for b in group)
                # one host sync per epoch
                train_loss = float(
                    torch.cat([l.reshape(-1) for l in losses]).mean())
                seconds = time.perf_counter() - t0
                events_per_s = n_events / max(seconds, 1e-9)
                history["train_loss"].append(train_loss)
                if profiler is not None:
                    profiler.stop()
                    os.makedirs(profile_dir, exist_ok=True)
                    profiler.export_chrome_trace(
                        os.path.join(profile_dir, "trace.json"))
                    logger.info("profiler trace written to %s", profile_dir)
                    profiler = None
                if last_ckpt is not None:
                    self.save_train_state(last_ckpt, epoch)
                lr = self._current_lr()
                msg = (f"epoch {epoch}: train_loss={train_loss:.4f} "
                       f"({seconds:.1f}s, {events_per_s:.0f} events/s"
                       + (f", lr={lr:.3e})" if np.isfinite(lr) else ")"))
                epoch_metrics = {"train_loss": train_loss,
                                 "events_per_s": events_per_s}
                if np.isfinite(lr):
                    epoch_metrics["lr"] = lr
                pad_eff = getattr(train_loader, "padding_efficiency", None)
                if pad_eff is not None and np.isfinite(pad_eff):
                    msg += f" pad_eff={pad_eff:.2f}"
                    epoch_metrics["padding_efficiency"] = pad_eff
                if val_loader is not None:
                    vals, counts = [], []
                    for batch in val_loader:
                        counts.append(batch.batch_size)
                        vals.append(self.eval_step(batch))
                    w = torch.tensor(counts, dtype=torch.float32,
                                     device=self.device)
                    val_loss = float((torch.stack(vals) * w).sum() / w.sum())
                    history["val_loss"].append(val_loss)
                    epoch_metrics["val_loss"] = val_loss
                    msg += f" val_loss={val_loss:.4f}"
                    if stopper.update(val_loss, epoch):
                        best_state = {
                            k: v.detach().clone()
                            for k, v in self.model.state_dict().items()
                        }
                        if ckpt_best and self.checkpoint_dir:
                            self.save_checkpoint(
                                os.path.join(self.checkpoint_dir, "best"))
                    if stopper.should_stop:
                        logger.info(
                            "early stopping at epoch %d (best epoch %d)",
                            epoch, stopper.best_epoch,
                        )
                        logger.info(msg)
                        self._log_metrics(epoch_metrics, step=self.step)
                        break
                logger.info(msg)
                self._log_metrics(epoch_metrics, step=self.step)
        finally:
            if profiler is not None:
                profiler.stop()
            if pipeline is not None:
                pipeline.close()
        if self.averaging is not None and self._avg is not None:
            self._swap_in_average()
            best_state = None  # the average supersedes the best epoch
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
                outs = prediction_arrays(
                    self.model(batch.to(self.device), inference=True))
                if per_task is None:
                    per_task = [[] for _ in outs]
                for chunks, pred in zip(per_task, outs):
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
                    for pred in prediction_arrays(self.model(
                        batch.to(self.device), inference=True))
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

    def save_model(self, directory: str) -> None:
        """``model.yml`` and ``state_dict.pkl`` in ``directory``, as the
        JAX Trainer writes them: both packages' ``DeploymentModule`` load
        them."""
        from graphnet_tpu_torch.utils.config import save_model_config

        os.makedirs(directory, exist_ok=True)
        save_model_config(self.model, os.path.join(directory, "model.yml"))
        self.save_state_dict(os.path.join(directory, "state_dict.pkl"))

    def load_state_dict(self, path: str) -> None:
        """Load a ``state_dict.pkl`` of either package into the model;
        the optimizer starts with fresh state, as in the JAX Trainer."""
        self.model.load_state_dict(
            load_jax_state_dict(path, expected=self.model.state_dict())
        )
        self._build_optimizer()

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """The parameters (the model's ``state_dict``) to the file
        ``path``: the serving / best-weights snapshot."""
        _save({"params": self.model.state_dict()}, path)

    def load_checkpoint(
        self, path: str, example_batch: Optional[EventBatch] = None
    ) -> None:
        """Load :meth:`save_checkpoint`'s file; the optimizer starts with
        fresh state.  ``example_batch`` (the JAX Trainer's argument) is
        not read."""
        payload = torch.load(path, map_location=self.device)
        self.model.load_state_dict(payload["params"])
        self._build_optimizer()

    def save_train_state(self, path: str, epoch: int) -> None:
        """The whole resumable state to the file ``path``: parameters,
        optimiser state, step, ``epoch``, and with averaging the average
        and its count (0 while unseeded)."""
        payload = {
            "params": self.model.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "meta": {"step": self.step, "epoch": epoch,
                     "optimizer": self._optimizer_signature()},
        }
        if self.averaging is not None:
            payload["avg"] = {"params": self._avg or {},
                              "count": float(self._avg_count)
                              if self._avg is not None else 0.0}
        _save(payload, path)

    def _optimizer_signature(self) -> str:
        """What a resume must match: the optimizer's class and the
        clipping (a schedule changes no optimizer state)."""
        return f"{type(self.optimizer).__name__} clip={self.clip_grad_norm}"

    def load_train_state(
        self, path: str, example_batch: Optional[EventBatch] = None
    ) -> int:
        """Restore :meth:`save_train_state`'s file; returns its epoch.
        The optimizer must be configured as the run that saved it."""
        payload = torch.load(path, map_location=self.device)
        if self.optimizer is None:
            self._build_optimizer()
        self.model.load_state_dict(payload["params"])
        try:
            if payload["meta"]["optimizer"] != self._optimizer_signature():
                raise ValueError(payload["meta"]["optimizer"])
            self.optimizer.load_state_dict(payload["opt_state"])
        except (ValueError, KeyError) as e:
            raise RuntimeError(
                "Training-state checkpoint does not match this Trainer's "
                "optimizer configuration: resume requires the same "
                "optimizer/schedule/clip_grad_norm settings as the run "
                f"that saved {path!r}."
            ) from e
        self.step = int(payload["meta"]["step"])
        self._attach_schedule()
        avg = payload.get("avg")
        if self.averaging is not None and avg and avg["count"] > 0:
            self._avg = {n: a.clone() for n, a in avg["params"].items()}
            self._avg_count = int(avg["count"])
        return int(payload["meta"]["epoch"])
