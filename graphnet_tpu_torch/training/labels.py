"""Labels computed from an event's truth on the host (counterpart of
``graphnet_tpu/training/labels.py``): ``SQLiteDataset(labels={key:
Label})`` stores ``label(event)`` under ``key``, and the DataLoader's
batched route calls ``label.batched(columns)`` on the ``[B]`` truth
columns of a whole batch.  numpy only, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from graphnet_tpu_torch.utils.config import save_config


class Label:
    """A label: a function of an Event, stored under ``key``.  A
    subclass may define ``batched(labels)``, the label of a whole batch
    from its ``[B]`` label columns; the DataLoader's batched route needs
    it and falls back to the per-event route without it."""

    @save_config
    def __init__(self, key: str):
        self._key = key

    @property
    def key(self) -> str:
        return self._key

    def __call__(self, event) -> np.ndarray:
        raise NotImplementedError


def _unit_vectors(azimuth, zenith) -> np.ndarray:
    """``[..., 3]`` float32 unit vectors of float64 angles."""
    return np.stack([np.cos(azimuth) * np.sin(zenith),
                     np.sin(azimuth) * np.sin(zenith),
                     np.cos(zenith)], axis=-1).astype(np.float32)


class Direction(Label):
    """The unit 3-vector ``(cos az sin ze, sin az sin ze, cos ze)`` of
    the truth's azimuth and zenith."""

    @save_config
    def __init__(
        self,
        key: str = "direction",
        azimuth_key: str = "azimuth",
        zenith_key: str = "zenith",
    ):
        super().__init__(key=key)
        self._azimuth_key = azimuth_key
        self._zenith_key = zenith_key

    def __call__(self, event) -> np.ndarray:
        az = np.asarray(event.labels[self._azimuth_key],
                        np.float64).reshape(-1)
        ze = np.asarray(event.labels[self._zenith_key],
                        np.float64).reshape(-1)
        return _unit_vectors(az, ze).squeeze(0)

    def batched(self, labels: Dict[str, np.ndarray]) -> np.ndarray:
        """``[B, 3]`` unit vectors from ``[B]`` azimuth and zenith."""
        return _unit_vectors(np.asarray(labels[self._azimuth_key], np.float64),
                             np.asarray(labels[self._zenith_key], np.float64))


class Track(Label):
    """1 for a muon-neutrino charged-current event (``|pid| == 14`` and
    ``interaction_type == 1``), else 0."""

    @save_config
    def __init__(
        self,
        key: str = "track",
        pid_key: str = "pid",
        interaction_key: str = "interaction_type",
    ):
        super().__init__(key=key)
        self._pid_key = pid_key
        self._int_key = interaction_key

    def __call__(self, event) -> np.ndarray:
        return self.batched(event.labels)

    def batched(self, labels: Dict[str, np.ndarray]) -> np.ndarray:
        is_numu = np.abs(np.asarray(labels[self._pid_key])) == 14
        is_cc = np.asarray(labels[self._int_key]) == 1
        return np.asarray(is_numu & is_cc, np.int32)
