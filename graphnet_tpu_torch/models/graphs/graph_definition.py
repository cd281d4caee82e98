"""The per-event record (counterpart of the ``Event`` dataclass in
``graphnet_tpu/models/graphs/graph_definition.py``).

``GraphDefinition`` and the detectors, which build events from raw
pulses, are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np


@dataclass
class Event:
    """One processed event: node array + truth labels."""

    x: np.ndarray  # [n_nodes, d] float32
    features: List[str]
    labels: Dict[str, Any] = field(default_factory=dict)
    node_labels: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def n_pulses(self) -> int:
        return self.x.shape[0]
