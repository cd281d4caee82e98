"""The public Prometheus datasets (counterpart of
``graphnet_tpu/datasets/prometheus_datasets.py``), downloaded from ERDA
on first use."""

from __future__ import annotations

import os
from glob import glob
from typing import Any, Dict, List, Optional, Tuple

from graphnet_tpu_torch.data.constants import FEATURES
from graphnet_tpu_torch.data.curated_datamodule import ERDAHostedDataset


class PublicPrometheusDataset(ERDAHostedDataset):
    """A public Prometheus simulation: one ``.db`` in ``dataset_dir``
    (``"sqlite"``) or its ``merged`` Parquet directory."""

    _pulsemaps = ["photons"]
    _truth_table = "mc_truth"
    _event_truth = [
        "interaction",
        "initial_state_energy",
        "initial_state_type",
        "initial_state_zenith",
        "initial_state_azimuth",
        "initial_state_x",
        "initial_state_y",
        "initial_state_z",
    ]
    _pulse_truth = None
    _features = FEATURES.PROMETHEUS
    _creator = "Prometheus collaboration"
    _citation = "arXiv:2304.14526"

    def _prepare_args(
        self, backend: str, features: List[str], truth: List[str]
    ) -> Tuple[Dict[str, Any], Optional[list], Optional[list]]:
        if backend == "sqlite":
            paths = glob(os.path.join(self.dataset_dir, "*.db"))
            assert len(paths) == 1, (
                f"expected one .db in {self.dataset_dir}, got {paths}")
            path = paths[0]
        else:
            path = os.path.join(self.dataset_dir, "merged")
        dataset_args = {
            "path": path,
            "graph_definition": self._graph_definition,
            "pulsemaps": self._pulsemaps,
            "features": features,
            "truth": truth,
            "truth_table": self._truth_table,
        }
        return dataset_args, None, None


class TRIDENTSmall(PublicPrometheusDataset):
    """~1M track events in a TRIDENT-like geometry."""

    _experiment = "TRIDENT Prometheus Simulation"
    _comments = "Simulated tracks in a TRIDENT-1211-like water geometry."
    _file_hashes = {"sqlite": "E2d79DBhE9"}


class PONESmall(PublicPrometheusDataset):
    """~1M track events in a P-ONE-like geometry."""

    _experiment = "P-ONE Prometheus Simulation"
    _comments = "Simulated tracks in a P-ONE triangle water geometry."
    _file_hashes = {"sqlite": "GDaGfdD3FW"}


class BaikalGVDSmall(PublicPrometheusDataset):
    """~1M track events in a Baikal-GVD-like geometry."""

    _experiment = "Baikal-GVD Prometheus Simulation"
    _comments = "Simulated tracks in a Baikal-GVD-like water geometry."
    _file_hashes = {"sqlite": "FDIbddGBC5"}
