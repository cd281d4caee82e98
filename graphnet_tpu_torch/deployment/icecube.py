"""IceTray deployment (counterpart of ``graphnet_tpu/deployment/icecube.py``):
a trained model inside an I3Tray chain, one physics frame at a time.

``I3InferenceModule`` writes the model's answers into the frame as
``I3Double``s (``{model_name}_{column}``); ``I3PulseCleanerModule``, for
a node-level classifier, writes the pulses it keeps as
``{pulsemap}_{model_name}_cleaned``; ``I3Deployer`` runs modules over
``.i3`` files in worker processes.  Each takes ``device`` (the GPU unless
the caller asks for the CPU) and needs IceTray to run: without it
``__call__`` and ``_process_files`` raise ``ImportError``.

Two departures from the JAX package, each where its code cannot run:

* the event is built from the graph definition's own input features,
  taken by name from the extractor's columns; the JAX module hands the
  graph definition every column of the extractor in the extractor's
  order, which raises unless the two lists are the same;
* the cleaner reads its event's ``[n_pulses, n_columns]`` array from the
  list that ``DeploymentModule`` returns for a node-level model; the JAX
  cleaner indexes that list as an array (``probs[:, 0]``) and raises
  ``TypeError``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from graphnet_tpu_torch.deployment.deployer import Deployer
from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule
from graphnet_tpu_torch.device import DeviceLike
from graphnet_tpu_torch.models.graphs.graph_definition import (
    Event,
    GraphDefinition,
)
from graphnet_tpu_torch.utils.imports import has_icecube_package, requires_icecube


def _rebuild(cls, kwargs, graph_definition):
    module = cls(**kwargs)
    if graph_definition is not None:
        module.set_graph_definition(graph_definition)
    return module


class I3InferenceModule(DeploymentModule):
    """Per frame: the pulse map's features (``pulsemap_extractor``)
    through the graph definition and the model, each answer written into
    the frame as an ``I3Double``."""

    def __init__(
        self,
        pulsemap_extractor,
        model_config: str,
        state_dict: str,
        gcd_file: str,
        prediction_columns: Optional[List[str]] = None,
        model_name: Optional[str] = None,
        device: DeviceLike = "cuda",
    ):
        """Args:
        pulsemap_extractor: an ``I3FeatureExtractor`` of the pulse map
            the model reads; its GCD is ``gcd_file``.
        model_config, state_dict, prediction_columns, device: as
            :class:`DeploymentModule`'s.
        gcd_file: the GCD file of the frames to be served.
        model_name: the prefix of the keys written into the frame.

        A module built from two paths pickles as its arguments and its
        graph definition, and is built anew where it is unpickled (an
        ``I3Deployer``'s spawned workers).
        """
        super().__init__(model_config=model_config, state_dict=state_dict,
                         prediction_columns=prediction_columns, device=device)
        self._pulsemap_extractor = pulsemap_extractor
        self._model_name = model_name or "graphnet_tpu"
        self._gcd_file = gcd_file
        self._kwargs = dict(
            pulsemap_extractor=pulsemap_extractor, model_config=model_config,
            state_dict=state_dict, gcd_file=gcd_file,
            prediction_columns=prediction_columns, model_name=model_name,
            device=str(self.device))
        if has_icecube_package():
            self._pulsemap_extractor.set_gcd(i3_file=gcd_file,
                                             gcd_file=gcd_file)
        self._graph_definition: Optional[GraphDefinition] = None

    def __reduce_ex__(self, protocol):
        if self._files is None:
            return super().__reduce_ex__(protocol)
        return (_rebuild, (type(self), self._kwargs, self._graph_definition))

    def set_graph_definition(self, gd: GraphDefinition) -> None:
        self._graph_definition = gd

    def _event(self, frame) -> Event:
        """The frame's event: the graph definition's input features,
        by name, of the extractor's columns."""
        assert self._graph_definition is not None, (
            "call set_graph_definition first")
        features = self._pulsemap_extractor(frame)
        names = list(self._graph_definition._input_feature_names)
        arr = np.stack([np.asarray(features[k], np.float64) for k in names],
                       axis=1)
        return self._graph_definition(arr, names)

    @requires_icecube
    def __call__(self, frame) -> bool:
        from icecube.dataclasses import I3Double  # pyright: ignore

        preds = DeploymentModule.__call__(self, self._event(frame))[0]
        for col, value in zip(self.prediction_columns, preds):
            frame[f"{self._model_name}_{col}"] = I3Double(float(value))
        return True


class I3PulseCleanerModule(I3InferenceModule):
    """A node-level classifier: the frame's pulses of ``pulsemap`` whose
    first output exceeds ``threshold``, written into the frame as a new
    pulse map."""

    def __init__(self, pulsemap: str, threshold: float = 0.7, **kwargs: Any):
        super().__init__(**kwargs)
        self._pulsemap = pulsemap
        self._threshold = threshold
        self._kwargs.update(pulsemap=pulsemap, threshold=threshold)

    def probabilities(self, frame) -> np.ndarray:
        """The model's ``[n_pulses, n_columns]`` answer for the frame's
        event."""
        return DeploymentModule.__call__(self, self._event(frame))[0]

    @requires_icecube
    def __call__(self, frame) -> bool:
        from icecube import dataclasses  # pyright: ignore

        keep = self.probabilities(frame)[:, 0] > self._threshold
        pulse_map = dataclasses.I3RecoPulseSeriesMap.from_frame(
            frame, self._pulsemap)
        cleaned = dataclasses.I3RecoPulseSeriesMap()
        i = 0
        for om_key, pulses in pulse_map.items():
            kept = []
            for p in pulses:
                if i < len(keep) and keep[i]:
                    kept.append(p)
                i += 1
            if kept:
                cleaned[om_key] = dataclasses.vector_I3RecoPulse(kept)
        frame[f"{self._pulsemap}_{self._model_name}_cleaned"] = cleaned
        return True


class I3Deployer(Deployer):
    """Runs the modules over ``.i3`` files in an I3Tray chain (the GCD
    file first), each file's frames written to ``<name>_graphnet_tpu.i3``
    beside it, the files shared among ``n_workers`` spawned processes."""

    def __init__(
        self,
        modules: Sequence[I3InferenceModule],
        gcd_file: str,
        n_workers: int = 1,
    ):
        super().__init__(modules=modules, n_workers=n_workers)
        self._gcd_file = gcd_file

    @requires_icecube
    def _process_files(self, file_shard: List[str]) -> None:
        from I3Tray import I3Tray  # pyright: ignore

        for i3_file in file_shard:
            i3_file = str(i3_file)
            tray = I3Tray()
            tray.Add("I3Reader", "reader",
                     FilenameList=[self._gcd_file, i3_file])
            for i, module in enumerate(self._modules):
                tray.Add(lambda frame, m=module: m(frame), f"inference_{i}")
            out = i3_file.replace(".i3", "_graphnet_tpu.i3")
            tray.Add("I3Writer", "writer", Filename=out)
            tray.Execute()
            tray.Finish()
