"""StandardModel: backbone + task heads, with summed task losses
(counterpart of ``graphnet_tpu/models/standard_model.py``)."""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.device import DeviceLike, resolve_device
from graphnet_tpu_torch.models.components.layers import init_parameters
from graphnet_tpu_torch.models.gnn.gnn import GNN
from graphnet_tpu_torch.models.task.task import Task
from graphnet_tpu_torch.utils.config import save_config


class StandardModel(nn.Module):
    """Backbone + one or more task heads.

    The parameters are initialised from ``torch.Generator().manual_seed(
    seed)`` on the CPU and then moved to ``device`` (the GPU unless the
    caller asks for the CPU).  The tasks are registered as ``tasks_0``,
    ``tasks_1``, ..., the JAX package's parameter names.

    ``edge_definition`` is the JAX field of that name, in its place after
    ``tasks``: an edge rule (:mod:`~graphnet_tpu_torch.models.graphs.
    edges`) evaluated on the batch's device before the backbone, whenever
    the batch carries no edges; the backbones that read ``batch.edges``
    (DynEdge, DynEdgeJINST, DynEdgeTITO, ConvNet, ParticleNeT) then take
    its graph.  ``None`` leaves the backbone to build its own graph.

    ``eval()`` is the counterpart of the JAX package's
    ``deterministic_clone``: the stochastic layers of a backbone built
    with ``deterministic=False`` are on in training mode only.
    """

    @save_config(ignore=("seed", "device"))
    def __init__(
        self,
        backbone: GNN,
        tasks: Sequence[Task],
        edge_definition: Optional[object] = None,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.edge_definition = edge_definition
        self.backbone = backbone
        self.n_tasks = len(tasks)
        for i, task in enumerate(tasks):
            self.add_module(f"tasks_{i}", task)
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    @property
    def tasks(self) -> List[Task]:
        return [getattr(self, f"tasks_{i}") for i in range(self.n_tasks)]

    def forward(
        self, batch: EventBatch, inference: bool = False
    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        if self.edge_definition is not None and batch.edges is None:
            idx, edge_mask = self.edge_definition.build(batch.x, batch.mask)
            batch = replace(batch, edges=idx, edge_mask=edge_mask)
        latents = self.backbone(batch)
        return [task(latents, inference=inference) for task in self.tasks]

    def loss(
        self,
        outputs: List[Tuple[torch.Tensor, torch.Tensor]],
        labels: Dict[str, torch.Tensor],
        weights: Optional[torch.Tensor] = None,
        node_labels: Optional[Dict[str, torch.Tensor]] = None,
        mask: Optional[torch.Tensor] = None,
        event_weights: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Sum of the tasks' losses."""
        losses = [
            task.compute_loss(
                pred,
                reg,
                labels,
                weights=weights,
                node_labels=node_labels,
                mask=mask,
                event_weights=event_weights,
            )
            for task, (pred, reg) in zip(self.tasks, outputs)
        ]
        return torch.stack(losses).sum()

    def loss_from_batch(
        self, outputs: List[Tuple[torch.Tensor, torch.Tensor]], batch: EventBatch
    ) -> torch.Tensor:
        """Loss with the truth, node truth, mask and event weights routed
        from the batch."""
        return self.loss(
            outputs,
            batch.labels,
            node_labels=batch.node_labels,
            mask=batch.mask,
            event_weights=batch.event_weight,
        )

    @property
    def target_labels(self) -> List[str]:
        return [l for task in self.tasks for l in task.targets]

    @property
    def prediction_labels(self) -> List[str]:
        return [l for task in self.tasks for l in task.predictions]
