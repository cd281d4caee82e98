"""Prometheus simulation extractors (counterpart of
``graphnet_tpu/data/extractors/prometheus.py``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from graphnet_tpu_torch.data.extractors.extractor import Extractor


class PrometheusExtractor(Extractor):
    """The named columns of one table of a Prometheus event record; a
    column the record lacks is warned about once and left empty."""

    def __init__(self, extractor_name: str, columns: List[str]):
        super().__init__(extractor_name=extractor_name)
        self._table = extractor_name
        self._columns = columns

    def __call__(self, event) -> Dict[str, list]:
        """``event`` maps a column to a value or a list of values."""
        output: Dict[str, list] = {key: [] for key in self._columns}
        for key in self._columns:
            if key in event.keys():
                data = event[key]
                if isinstance(data, np.ndarray):
                    data = data.tolist()
                if isinstance(data, list):
                    output[key].extend(data)
                else:
                    output[key].append(data)
            else:
                self.warning_once(f"{key} not found in {self._table}!")
        return output


class PrometheusTruthExtractor(PrometheusExtractor):
    """The event's neutrino truth (``mc_truth``)."""

    def __init__(self, table_name: str = "mc_truth") -> None:
        super().__init__(
            extractor_name=table_name,
            columns=[
                "interaction",
                "initial_state_energy",
                "initial_state_type",
                "initial_state_zenith",
                "initial_state_azimuth",
                "initial_state_x",
                "initial_state_y",
                "initial_state_z",
            ],
        )


class PrometheusFeatureExtractor(PrometheusExtractor):
    """The photons' features (``photons``)."""

    def __init__(self, table_name: str = "photons") -> None:
        super().__init__(
            extractor_name=table_name,
            columns=[
                "sensor_pos_x",
                "sensor_pos_y",
                "sensor_pos_z",
                "string_id",
                "sensor_id",
                "t",
            ],
        )
