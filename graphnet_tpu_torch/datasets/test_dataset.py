"""The curated dataset over the bundled example data (counterpart of
``graphnet_tpu/datasets/test_dataset.py``)."""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from graphnet_tpu_torch.constants import EXAMPLE_DATA_DIR
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.curated_datamodule import CuratedDataset


class TestDataset(CuratedDataset):
    """The bundled 50-event Prometheus database (``backend="sqlite"``) or
    its chunked Parquet copy (``"parquet"``)."""

    _pulsemaps = ["total"]
    _truth_table = "mc_truth"
    _event_truth = TRUTH.PROMETHEUS
    _pulse_truth = None
    _features = FEATURES.PROMETHEUS
    _experiment = "Prometheus example simulation"
    _creator = "bundled"
    _comments = "50-event example dataset shipped with the repo."
    _available_backends = ["sqlite", "parquet"]

    def __init__(self, graph_definition, **kwargs: Any) -> None:
        super().__init__(graph_definition=graph_definition,
                         download_dir=EXAMPLE_DATA_DIR, **kwargs)

    @property
    def dataset_dir(self) -> str:
        return EXAMPLE_DATA_DIR

    def _prepare_args(
        self, backend: str, features: List[str], truth: List[str]
    ) -> Tuple[Dict[str, Any], Optional[list], Optional[list]]:
        if backend == "sqlite":
            path = os.path.join(EXAMPLE_DATA_DIR, "sqlite", "prometheus",
                                "prometheus-events.db")
        else:
            path = os.path.join(EXAMPLE_DATA_DIR, "parquet", "prometheus",
                                "merged")
        dataset_args = {
            "path": path,
            "graph_definition": self._graph_definition,
            "pulsemaps": self._pulsemaps,
            "features": features,
            "truth": truth,
            "truth_table": self._truth_table,
        }
        return dataset_args, None, None
