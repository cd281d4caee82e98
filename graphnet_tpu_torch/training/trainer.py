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

Across processes, one a device (``mesh``: a ``DeviceMesh`` of
:mod:`graphnet_tpu_torch.parallel`, after ``init_distributed``): the
global batch is padded to a multiple of the data axis (pad events copy
the last event with ``event_weight`` 0, real events carry ``B_pad /
B``, so the mean loss is the unpadded one) and each process keeps its
slice, or, from a process-local stream (a loader with ``process_count >
1``: ``MaterializedLoader(process_index=, process_count=)``), its batch
as it comes; under a ``graph`` axis also its rows of the node axis.
``param_sharding`` places the model: ``"replicated"`` is DDP (over the
data axis, or the whole mesh with a graph axis), ``"fsdp"`` FSDP2 by the
JAX package's rule (parameters below its ``min_size`` stay replicated,
their gradients averaged over the data axis by the Trainer), ``"tp"``
Megatron shards of the attention and feed-forward layers over the model
axis (DDP over data for the rest), ``"fsdp+tp"`` TP for those layers and
FSDP2 for the others.  Every process steps in lockstep: the epoch's
train and validation losses are averaged across them, the resume
decision is taken on rank 0 and broadcast, ``predict`` answers exactly
this process's events, and a training checkpoint is one file a process
(``<dir>/rank<r>.pt``), written and read by every process; ``best``,
``save_state_dict`` and ``save_model`` gather the whole parameters and
write them from rank 0 in the single-process formats.
"""

from __future__ import annotations

import contextlib
import logging
import os
import pickle
import time
from dataclasses import replace
from typing import (Any, Callable, Dict, Iterable, List, Optional, Protocol,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.distributed as dist

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


def _process_local(loader) -> bool:
    """Whether ``loader`` yields this process's own batches (a loader
    sharded over processes, ``MaterializedLoader(process_index=,
    process_count=)`` with ``process_count > 1``), not global ones."""
    return (getattr(loader, "process_count", None) or 1) > 1


def _local(t):
    """A DTensor's local shard, copied; anything else as it is (nested
    dicts and lists too)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t.to_local().detach().clone()
    if isinstance(t, dict):
        return {k: _local(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_local(v) for v in t)
    return t


def _gather_shards(t) -> torch.Tensor:
    """The whole tensor of an FSDP2 DTensor (evenly sharded on one
    dimension of a 1-D mesh), by one c10d all-gather of the local shards.
    Not ``DTensor.full_tensor``: its functional all-gather over gloo on
    CUDA tensors ends the process (two processes sharing an H100, torch
    2.11, ``tools/collectives_probe.py``), where c10d's passes."""
    from torch.distributed.tensor import Shard

    local = t.to_local().detach().contiguous()
    (place,) = t.placements
    if not isinstance(place, Shard):
        return local
    group = t.device_mesh.get_group()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=place.dim)


def _like(target: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` (a saved shard) as a tensor of ``target``'s kind: a DTensor
    with ``target``'s mesh and placements where ``target`` is one."""
    from torch.distributed.tensor import DTensor

    local = local.to(target.device)
    if isinstance(target, DTensor):
        return DTensor.from_local(local, target.device_mesh, target.placements,
                                  shape=target.shape, stride=target.stride())
    return local


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
        mesh: Optional[Any] = None,
        data_axis: str = "data",
        model_axis: str = "model",
        param_sharding: str = "replicated",
        fsdp_min_size: int = 2**14,
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
        mesh: a ``DeviceMesh`` over the processes (``parallel.make_mesh``
            or ``make_dp_graph_mesh``); the model must already sit on
            this process's device.  ``data_axis`` and ``model_axis`` name
            its axes.
        param_sharding: ``"replicated"``, ``"fsdp"``, ``"tp"`` or
            ``"fsdp+tp"`` (see the module docstring); all but the first
            need a mesh, the TP ones a mesh with ``model_axis``.
        fsdp_min_size: parameters with fewer elements stay replicated
            under FSDP (the JAX rule's ``min_size``).
        """
        if param_sharding not in ("replicated", "fsdp", "tp", "fsdp+tp"):
            raise ValueError(f"unknown param_sharding {param_sharding!r}")
        if param_sharding != "replicated" and mesh is None:
            raise ValueError(f"param_sharding={param_sharding!r} requires "
                             "mesh=... (graphnet_tpu_torch.parallel.make_mesh)")
        if "tp" in param_sharding and model_axis not in mesh.mesh_dim_names:
            raise ValueError(f"param_sharding={param_sharding!r} needs a mesh "
                             f"with a {model_axis!r} axis (make_mesh(n_data, "
                             "n_model))")
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
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.param_sharding = param_sharding
        self.fsdp_min_size = fsdp_min_size
        self._forward = model  # the module a training forward calls
        self._manual: List[torch.nn.Parameter] = []  # grads averaged here
        self._local_stream = False
        if mesh is not None:
            self._place()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _param_groups(self):
        """The model's parameters; under FSDP two groups, the sharded
        (DTensor) ones and the replicated ones, since a multi-tensor
        optimizer step refuses a list that mixes the two kinds."""
        params = list(self.model.parameters())
        if "fsdp" not in self.param_sharding:
            return params
        from torch.distributed.tensor import DTensor

        groups = [[p for p in params if isinstance(p, DTensor)],
                  [p for p in params if not isinstance(p, DTensor)]]
        return [{"params": g} for g in groups if g]

    def _build_optimizer(self) -> None:
        if self._factory is None:
            self.optimizer = torch.optim.Adam(
                self._param_groups(), lr=self._lr, eps=1e-3
            )
        else:
            self.optimizer = self._factory(self._param_groups())
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
    # across processes
    def _axis(self, name: str) -> Tuple[int, int]:
        """``(size, index)`` of this process on mesh axis ``name``."""
        from graphnet_tpu_torch.parallel.mesh import axis_index, axis_size

        return axis_size(self.mesh, name), axis_index(self.mesh, name)

    @property
    def _graph(self) -> bool:
        return self.mesh is not None and "graph" in self.mesh.mesh_dim_names

    def _data_group(self):
        return self.mesh.get_group(self.data_axis)

    def _place(self) -> None:
        """Shard or replicate the model by ``param_sharding`` (once, at
        construction, before the optimizer exists)."""
        from graphnet_tpu_torch.parallel.mesh import shard_fsdp
        from graphnet_tpu_torch.parallel.tensor_parallel import (
            shard_tensor_parallel,
            tp_params,
        )

        tp = set()
        if "tp" in self.param_sharding:
            if shard_tensor_parallel(self.model, self.mesh, self.model_axis) == 0:
                raise ValueError("TP sharding matched no parameters")
            tp = set(tp_params(self.model))
        n_data = self._axis(self.data_axis)[0]
        if "fsdp" in self.param_sharding:
            if self._graph:
                raise NotImplementedError("fsdp with a graph axis")
            ignored = shard_fsdp(self.model, self.mesh, self.data_axis,
                                 self.fsdp_min_size, exclude=tp)
            if n_data > 1:
                self._manual = [p for p in self.model.parameters()
                                if p in ignored]
            return
        # DDP: averaged over the whole mesh with a graph axis (see
        # parallel/graph_sharding.py), over the data axis otherwise
        if self._graph:
            group, size = dist.group.WORLD, dist.get_world_size()
        else:
            group, size = self._data_group(), n_data
        if size > 1:
            dev = self.device
            self._forward = torch.nn.parallel.DistributedDataParallel(
                self.model, process_group=group, broadcast_buffers=False,
                find_unused_parameters=True,
                device_ids=[dev.index] if dev.type == "cuda" else None)

    def _pad_to_multiple(self, batch: EventBatch) -> EventBatch:
        """Pad the batch dimension of a global batch up to a multiple of
        the data axis: pad events copy the last event with
        ``event_weight`` 0, real events carry ``B_pad / B`` (the mean
        loss is then the unpadded one); after a divisible batch, ragged
        ones pad to that nominal size, as the JAX Trainer does."""
        if self.mesh is None or self._local_stream:
            return batch
        n = self._axis(self.data_axis)[0]
        B = batch.batch_size
        rem = B % n
        if rem == 0:
            self._nominal_batch_size = max(
                B, getattr(self, "_nominal_batch_size", 0))
            return batch
        nominal = getattr(self, "_nominal_batch_size", 0)
        Bp = nominal if nominal > B else B + (n - rem)
        pad = Bp - B
        idx = torch.cat([torch.arange(B), torch.full((pad,), B - 1)])

        def take(t):
            return t[idx.to(t.device)] if t.dim() >= 1 and t.shape[0] == B else t

        padded = batch.map(take)
        ew = batch.event_weight
        base = (ew.float() if ew is not None
                else torch.ones(B, device=batch.x.device))
        weight = torch.cat([base * (Bp / B),
                            torch.zeros(pad, device=base.device)])
        return replace(padded, event_weight=weight)

    def _rows(self, batch: EventBatch) -> Tuple[int, int, int]:
        """``(first, local, total)``: this process's events within the
        global batch (a process-local batch is the data index's block)."""
        n, i = self._axis(self.data_axis)
        if self._local_stream:
            B = batch.batch_size
            return i * B, B, n * B
        per = batch.batch_size // n
        return i * per, per, batch.batch_size

    def _split(self, batch: EventBatch):
        """``(part, rows)``: this process's part of ``batch`` on its
        device (the padded global batch's slice over the data axis, a
        process-local batch as it is, and under a graph axis its rows of
        the node axis) and its :meth:`_rows`."""
        if self.mesh is None:
            B = batch.batch_size
            return batch.to(self.device), (0, B, B)
        from graphnet_tpu_torch.parallel.distributed import shard_host_local
        from graphnet_tpu_torch.parallel.graph_sharding import (
            node_rows,
            shard_batch_nodes,
        )
        from graphnet_tpu_torch.parallel.mesh import shard_batch

        batch = self._pad_to_multiple(batch)
        rows = self._rows(batch)
        if self._local_stream:
            part = node_rows(batch, self.mesh) if self._graph else batch
            return shard_host_local(part, self.device), rows
        if self._graph:
            part = shard_batch_nodes(batch, self.mesh, self.data_axis)
        else:
            part = shard_batch(batch, self.mesh, self.data_axis)
        return part.to(self.device), rows

    @contextlib.contextmanager
    def _step_context(self, rows):
        """The graph hints and the stochastic layers' global rows around
        a forward under a mesh."""
        if self.mesh is None:
            yield
            return
        with self._hints(), stochastic.global_rows(*rows):
            yield

    def _hints(self):
        """The graph hints around a forward (parallel/graph_sharding.py)."""
        from graphnet_tpu_torch.parallel.graph_sharding import (
            graph_sharding_hints,
        )

        return graph_sharding_hints(self.mesh)

    def _sync_manual(self) -> None:
        """Average the gradients of the parameters FSDP2 left replicated
        over the data axis, in one all-reduce."""
        grads = [p.grad for p in self._manual if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self._data_group())
        flat /= self._axis(self.data_axis)[0]
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def _mean_over_processes(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over every process (a graph or model group
        holds equal values, so this is the data axis's mean)."""
        if self.mesh is None:
            return t
        t = t.detach().float().clone()
        dist.all_reduce(t)
        return t / dist.get_world_size()

    def _clip(self, max_norm: float) -> None:
        """``clip_by_global_norm`` over the whole (sharded) parameters:
        FSDP2 shards' squares summed over the data axis, TP shards' over
        the model axis, replicated ones once."""
        from torch.distributed.tensor import DTensor

        from graphnet_tpu_torch.parallel.tensor_parallel import tp_params

        tp = {id(p) for p in tp_params(self.model)}
        dev = self.device
        parts = {"data": torch.zeros((), device=dev),
                 "model": torch.zeros((), device=dev),
                 "none": torch.zeros((), device=dev)}
        grads = []
        for p in self.model.parameters():
            if p.grad is None:
                continue
            g = p.grad
            local = g.to_local() if isinstance(g, DTensor) else g
            key = ("data" if isinstance(g, DTensor)
                   else "model" if id(p) in tp else "none")
            parts[key] = parts[key] + (local.float() ** 2).sum()
            grads.append(local)
        if "fsdp" in self.param_sharding:
            dist.all_reduce(parts["data"], group=self._data_group())
        if "tp" in self.param_sharding:
            dist.all_reduce(parts["model"],
                            group=self.mesh.get_group(self.model_axis))
        norm = torch.sqrt(parts["data"] + parts["model"] + parts["none"])
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))

    # ------------------------------------------------------------------
    def init(self, example_batch: Optional[EventBatch] = None):
        """Build the optimizer and its state, from step 0.  The model
        already holds its parameters, so ``example_batch`` (the JAX
        Trainer's argument, which shapes ``model.init``) is not read."""
        self.step = 0
        self._build_optimizer()
        return self.optimizer

    def train_step(self, batch: EventBatch) -> torch.Tensor:
        """One optimiser step on ``batch`` (moved to the model's device;
        under a mesh, this process's part of it); returns the loss as a
        0-d tensor on the device (no host sync; under a mesh this
        process's loss, whose mean over the processes is the step's)."""
        if self.optimizer is None:
            self.init(batch)
        batch, rows = self._split(batch)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        # seeded at the step's first draw: a model with no stochastic
        # layer on never seeds it
        with stochastic.use_generator(self.step_generator), \
                self._step_context(rows):
            loss = self.model.loss_from_batch(self._forward(batch), batch)
            loss.backward()
        if self._manual:
            self._sync_manual()
        if self.clip_grad_norm is not None:
            if self.mesh is None:
                clip_by_global_norm(
                    list(self.model.parameters()), self.clip_grad_norm
                )
            else:
                self._clip(self.clip_grad_norm)
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
        """The loss on ``batch``, without gradients (0-d, on the device;
        under a mesh this process's part's loss)."""
        self.model.eval()
        with torch.no_grad():
            batch, rows = self._split(batch)
            with self._step_context(rows):
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
        device finishes epoch e.  Single-process only: under a mesh it
        raises ``NotImplementedError``.
        """
        if prefetch and self.mesh is not None:
            raise NotImplementedError(
                "fit(prefetch=...) under a mesh: the pipeline copies whole "
                "batches to the device, not this process's part")
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
        self._local_stream = _process_local(train_loader)
        do_resume = bool(resume and last_ckpt
                         and os.path.exists(self._state_file(last_ckpt)))
        if self.mesh is not None and resume and last_ckpt:
            # the files may be on rank 0's disk only: every process
            # follows rank 0's decision, so all restore in lockstep
            flag = [do_resume]
            dist.broadcast_object_list(
                flag, src=0,
                device=self.device if self.device.type == "cuda" else None)
            do_resume = bool(flag[0])
        if do_resume:
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
                # one host sync per epoch (one all-reduce under a mesh)
                train_loss = float(self._mean_over_processes(
                    torch.cat([l.reshape(-1) for l in losses]).mean()))
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
                    val_loss = self._validate(val_loader)
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

    def _validate(self, val_loader) -> float:
        """The event-count-weighted mean validation loss, every process
        in lockstep (one all-reduce under a mesh)."""
        local = _process_local(val_loader)
        stream, self._local_stream = self._local_stream, local
        n = self._axis(self.data_axis)[0] if local else 1
        try:
            vals, counts = [], []
            for batch in val_loader:
                counts.append(batch.batch_size * n)
                vals.append(self.eval_step(batch))
        finally:
            self._local_stream = stream
        w = torch.tensor(counts, dtype=torch.float32, device=self.device)
        total = self._mean_over_processes((torch.stack(vals) * w).sum())
        return float(total / w.sum())

    def _predict_batches(self, loader):
        """``(part, keep, outs)`` per batch: this process's part of the
        batch, how many of its first events are real (not mesh padding)
        and the per-task predictions of the part."""
        self.model.eval()
        self._local_stream = _process_local(loader)
        # inference mode holds no FSDP2 all-gather; no_grad under a mesh
        mode = torch.inference_mode if self.mesh is None else torch.no_grad
        with mode():
            for batch in loader:
                real_b = batch.batch_size
                part, (first, local, _) = self._split(batch)
                with self._hints():
                    outs = prediction_arrays(self.model(part, inference=True))
                keep = (local if self.mesh is None or self._local_stream
                        else max(0, min(local, real_b - first)))
                yield part, keep, outs

    def predict(self, loader) -> List[np.ndarray]:
        """Per-task predictions (inference transforms applied),
        concatenated over the batches, on the host.  Under a mesh: the
        predictions of exactly this process's events (its slice of each
        global batch, mesh padding dropped, or its process-local
        batches)."""
        per_task: Optional[List[List[np.ndarray]]] = None
        for _, keep, outs in self._predict_batches(loader):
            if per_task is None:
                per_task = [[] for _ in outs]
            for chunks, pred in zip(per_task, outs):
                chunks.append(pred[:keep].float().cpu().numpy())
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
        if node_level and self._graph:
            raise NotImplementedError("node-level predictions under node "
                                      "sharding")
        for batch, keep, outs in self._predict_batches(loader):
            outs = [pred[:keep].float().cpu().numpy() for pred in outs]
            batch = batch.map(lambda t: t[:keep])
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
    def _full_state(self, state: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
        """The model's whole ``state_dict`` (or ``state``, tensors named
        and shaped as it, such as the gradients): FSDP2 and TP shards
        gathered (collective under a mesh: every process calls it)."""
        if state is None:
            state = self.model.state_dict()
        if self.mesh is None:
            return state
        from torch.distributed.tensor import DTensor

        from graphnet_tpu_torch.parallel.tensor_parallel import full_tp_state

        if "tp" in self.param_sharding:
            state = full_tp_state(self.model, state)
        return {k: _gather_shards(v) if isinstance(v, DTensor) else v
                for k, v in state.items()}

    def _load_full(self, full: Dict[str, torch.Tensor]) -> None:
        """Load a whole ``state_dict`` into the (sharded) model: each
        process copies its shards of it."""
        if self.mesh is None:
            self.model.load_state_dict(full)
            return
        from torch.distributed.tensor import DTensor

        from graphnet_tpu_torch.parallel.tensor_parallel import local_tp_state

        if "tp" in self.param_sharding:
            full = local_tp_state(self.model, full)
        with torch.no_grad():
            for name, t in self.model.state_dict().items():
                src = full[name].to(t.device)
                if isinstance(t, DTensor):
                    mesh, (place,) = t.device_mesh, t.placements
                    src = src.chunk(mesh.size(), place.dim)[mesh.get_local_rank()]
                    t.to_local().copy_(src)
                else:
                    t.copy_(src)

    def _rank0(self) -> bool:
        return self.mesh is None or dist.get_rank() == 0

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    def save_state_dict(self, path: str) -> None:
        """Write the parameters as the JAX Trainer's ``state_dict.pkl``
        (the JAX parameter tree of numpy arrays, pickled), which both
        packages' ``DeploymentModule``s load.  Under a mesh every process
        calls it and rank 0 writes the whole parameters."""
        tree = params_to_jax(self._full_state())
        if self._rank0():
            with open(path, "wb") as f:
                pickle.dump(tree, f)
        self._barrier()

    def save_model(self, directory: str) -> None:
        """``model.yml`` and ``state_dict.pkl`` in ``directory``, as the
        JAX Trainer writes them: both packages' ``DeploymentModule`` load
        them."""
        from graphnet_tpu_torch.utils.config import save_model_config

        if self._rank0():
            os.makedirs(directory, exist_ok=True)
            save_model_config(self.model, os.path.join(directory, "model.yml"))
        self.save_state_dict(os.path.join(directory, "state_dict.pkl"))

    def load_state_dict(self, path: str) -> None:
        """Load a ``state_dict.pkl`` of either package into the model;
        the optimizer starts with fresh state, as in the JAX Trainer."""
        self._load_full(load_jax_state_dict(path, expected=self._full_state()))
        self._build_optimizer()

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """The parameters (the model's ``state_dict``) to the file
        ``path``: the serving / best-weights snapshot (under a mesh the
        whole parameters, written by rank 0; every process calls it)."""
        full = self._full_state()
        if self._rank0():
            _save({"params": full}, path)
        self._barrier()

    def load_checkpoint(
        self, path: str, example_batch: Optional[EventBatch] = None
    ) -> None:
        """Load :meth:`save_checkpoint`'s file; the optimizer starts with
        fresh state.  ``example_batch`` (the JAX Trainer's argument) is
        not read."""
        payload = torch.load(path, map_location=self.device)
        self._load_full(payload["params"])
        self._build_optimizer()

    def _state_file(self, path: str) -> str:
        """The file of this process's training state: ``path`` itself, or
        ``<path>/rank<r>.pt`` under a mesh."""
        if self.mesh is None:
            return path
        return os.path.join(path, f"rank{dist.get_rank()}.pt")

    def save_train_state(self, path: str, epoch: int) -> None:
        """The whole resumable state to the file ``path``: parameters,
        optimiser state, step, ``epoch``, and with averaging the average
        and its count (0 while unseeded).  Under a mesh ``path`` is a
        directory: every process writes its own shards to
        ``rank<r>.pt`` (the same mesh must read them back)."""
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
        if self.mesh is not None:
            payload = _local(payload)
            payload["meta"]["world"] = dist.get_world_size()
        _save(payload, self._state_file(path))
        self._barrier()

    def _as_placed(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """A mesh checkpoint's local shards as tensors of the live
        parameters' kinds (DTensors where FSDP2 holds them)."""
        from torch.distributed.tensor import DTensor

        if payload["meta"].get("world") != dist.get_world_size():
            raise RuntimeError("a training state saved on another mesh")
        state = self.model.state_dict()
        payload["params"] = {k: _like(state[k], v)
                             for k, v in payload["params"].items()}
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for i, entry in payload["opt_state"]["state"].items():
            p = params[int(i)]
            for key, v in entry.items():
                shape = p.to_local().shape if isinstance(p, DTensor) else p.shape
                if torch.is_tensor(v) and key != "step" and v.shape == shape:
                    entry[key] = _like(p, v)
        named = dict(self.model.named_parameters())
        avg = payload.get("avg")
        if avg and avg["params"]:
            avg["params"] = {k: _like(named[k], v)
                             for k, v in avg["params"].items()}
        return payload

    def _optimizer_signature(self) -> str:
        """What a resume must match: the optimizer's class and the
        clipping (a schedule changes no optimizer state)."""
        return f"{type(self.optimizer).__name__} clip={self.clip_grad_norm}"

    def load_train_state(
        self, path: str, example_batch: Optional[EventBatch] = None
    ) -> int:
        """Restore :meth:`save_train_state`'s file; returns its epoch.
        The optimizer must be configured as the run that saved it (and,
        under a mesh, the mesh too: each process reads its own file)."""
        payload = torch.load(self._state_file(path), map_location=self.device)
        if self.optimizer is None:
            self._build_optimizer()
        if self.mesh is not None:
            payload = self._as_placed(payload)
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
