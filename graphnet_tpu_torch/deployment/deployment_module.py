"""DeploymentModule: a trained model applied to raw events at inference
time (counterpart of ``graphnet_tpu/deployment/deployment_module.py``).

As in the JAX package, a module is built from a ``model.yml`` and a
``state_dict.pkl`` (the JAX-layout parameter tree that either package's
trainer or ``utils.config.save_model`` writes).  It also takes a port
model object, with such a pickle or a torch state dict.
"""

from __future__ import annotations

import os
from typing import List, Mapping, Optional, Union

import numpy as np
import torch

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.data.dataloader import collate_events
from graphnet_tpu_torch.device import DeviceLike, resolve_device
from graphnet_tpu_torch.models.graphs.graph_definition import Event
from graphnet_tpu_torch.models.standard_model import StandardModel
from graphnet_tpu_torch.utils.config import load_model
from graphnet_tpu_torch.utils.jax_params import load_jax_state_dict


class DeploymentModule:
    """Trained model + weights, applied to events at inference time."""

    def __init__(
        self,
        model_config: Union[str, os.PathLike, StandardModel],
        state_dict: Union[str, os.PathLike, Mapping[str, torch.Tensor]],
        prediction_columns: Optional[List[str]] = None,
        device: DeviceLike = "cuda",
    ):
        """Args:
        model_config: path to a ``model.yml`` (built with
            ``utils.config.load_model`` on ``device``), or a port
            :class:`StandardModel`, which is moved to ``device``.
        state_dict: path to a pickled JAX-layout parameter tree (the JAX
            trainer's ``Trainer.save_state_dict``, either package's
            ``save_model``), or the model's torch ``state_dict``.
        prediction_columns: names for the output columns; defaults to the
            model's ``prediction_labels``.
        device: where inference runs: the GPU unless the caller asks for
            the CPU.

        A module built from two paths pickles as those paths and is
        built anew where it is unpickled (a ``Deployer``'s spawned
        workers).
        """
        self.device = resolve_device(device)
        from_files = isinstance(model_config, (str, os.PathLike)) and isinstance(
            state_dict, (str, os.PathLike))
        self._files = ((os.fspath(model_config), os.fspath(state_dict),
                        prediction_columns, str(self.device))
                       if from_files else None)
        if isinstance(model_config, (str, os.PathLike)):
            model_config = load_model(os.fspath(model_config), self.device)
        self.model = model_config.to(self.device).eval()
        if isinstance(state_dict, (str, os.PathLike)):
            state_dict = load_jax_state_dict(
                os.fspath(state_dict), expected=self.model.state_dict()
            )
        self.model.load_state_dict(state_dict)
        self.prediction_columns = list(
            prediction_columns or self.model.prediction_labels
        )

    def __reduce_ex__(self, protocol):
        if self._files is None:
            return super().__reduce_ex__(protocol)
        return (type(self), self._files)

    def _predict(self, events: List[Event]):
        """Collate, pad the batch axis, run the model; returns the
        per-task outputs trimmed to the real events, on the host."""
        batch = collate_events(events, min_pulses=1)
        n_real = batch.batch_size
        batch = self._pad_batch_size(batch).to(self.device)
        with torch.inference_mode():
            outs = self.model(batch, inference=True)
        return [pred[:n_real].float().cpu().numpy() for pred, _ in outs]

    def __call__(
        self, events: Union[Event, List[Event]]
    ) -> Union[np.ndarray, List[np.ndarray]]:
        """Predict on one or more events.

        Graph-level tasks: returns ``[n_events, n_cols]``, one row per
        input event (0-pulse events, which cannot be collated, give NaN
        rows so row alignment is kept).

        Node-level tasks: returns a list of per-event
        ``[n_pulses_i, n_cols]`` arrays.
        """
        if isinstance(events, Event):
            events = [events]
        node_level = [t.node_level for t in self.model.tasks]
        if any(node_level):
            if not all(node_level):
                raise NotImplementedError(
                    "DeploymentModule cannot mix node-level and "
                    "graph-level tasks in one model"
                )
            return self._call_node_level(events)
        kept = [i for i, e in enumerate(events) if e.n_pulses >= 1]
        full = np.full(
            (len(events), len(self.prediction_columns)), np.nan, np.float32
        )
        if kept:
            outs = self._predict([events[i] for i in kept])
            full[kept] = np.concatenate(outs, axis=1)
        return full

    def _call_node_level(self, events: List[Event]) -> List[np.ndarray]:
        ncols = len(self.prediction_columns)
        out = [
            np.full((e.n_pulses, ncols), np.nan, np.float32) for e in events
        ]
        kept = [i for i, e in enumerate(events) if e.n_pulses >= 1]
        if not kept:
            return out
        stacked = np.concatenate(
            self._predict([events[i] for i in kept]), axis=2
        )  # [n_real, L, ncols]
        L = stacked.shape[1]
        for j, i in enumerate(kept):
            n = min(events[i].n_pulses, L)
            out[i][:n] = stacked[j, :n]
        return out

    def export_serving(
        self,
        path: str,
        nb_inputs: Optional[int] = None,
        batch_sizes=(1, 8, 32, 128),
        lengths=(128,),
    ) -> dict:
        """Write a serving artifact (one ``torch.export`` program per
        ``(B, L)``, the weights held in each) that :class:`~graphnet_tpu_
        torch.deployment.export.ExportedModel` serves without any model
        code, traced on this module's device; see ``deployment/
        export.py``."""
        from graphnet_tpu_torch.deployment.export import export_serving

        if nb_inputs is None:
            nb_inputs = getattr(self.model.backbone, "nb_inputs", None)
            if nb_inputs is None:
                raise ValueError(
                    "backbone has no nb_inputs field; pass nb_inputs="
                )
        return export_serving(
            self.model,
            path,
            nb_inputs=nb_inputs,
            prediction_columns=self.prediction_columns,
            batch_sizes=batch_sizes,
            lengths=lengths,
            device=self.device,
        )

    @staticmethod
    def _pad_batch_size(batch: EventBatch) -> EventBatch:
        """Pad the batch axis up to the next power of two with all-masked
        events, so a server sees at most ``log2(max_B)`` batch sizes per
        length bucket.  Padded events are trimmed from the output; the
        model's outputs are per event, so real rows are unaffected."""
        B = batch.batch_size
        bb = 1
        while bb < B:
            bb *= 2
        if bb == B:
            return batch

        def pad(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
            if t is None or t.dim() == 0 or t.shape[0] != B:
                return t
            zeros = t.new_zeros((bb - B,) + tuple(t.shape[1:]))
            return torch.cat([t, zeros], dim=0)

        return EventBatch(
            x=pad(batch.x),
            mask=pad(batch.mask),
            n_pulses=pad(batch.n_pulses),
            labels={k: pad(v) for k, v in batch.labels.items()},
            node_labels={k: pad(v) for k, v in batch.node_labels.items()},
            edges=pad(batch.edges),
            edge_mask=pad(batch.edge_mask),
        )
